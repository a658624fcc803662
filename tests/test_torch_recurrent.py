"""PyTorch port vs the JAX package: the recurrent mixers (Mamba, mLSTM,
sLSTM) and the dense FFN.

The same seeded inputs and the JAX layer's weights (carried across with
``convert``'s leaf conversion) go through JAX's ``apply_*`` and the
port's, in prefill mode from a zero state (outputs and the final states)
and then one decode step continuing that state (output and state). f32
within 1e-5 x max(1, max|ref|), bf16 within 2e-2 x max|ref|; each state
leaf on its own. The prompt of 20 tokens does not divide the chunk of 8,
so both packages halve it (to 4).

Then the port alone, as ``tests/test_recurrent.py`` holds the JAX layers:
the chunked form equals the token-by-token decode form for chunks 4, 8
and 32 (Mamba, mLSTM), and sLSTM's decode continues its full-sequence
state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MambaConfig, ModelConfig, XLSTMConfig
from repro.models import mamba as jmamba
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch.configs import base as tbase
from repro_torch.convert import _map, _to_tensor
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

B, S = 2, 20
MCFG = dict(name="m", family="hybrid", num_layers=1, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=16,
            layer_pattern=("mamba",))
XCFG = dict(name="x", family="ssm", num_layers=1, d_model=32, num_heads=4,
            num_kv_heads=4, d_ff=0, vocab_size=16, layer_pattern=("mlstm",))

LAYERS = {
    "mamba": (jmamba.init_mamba, jmamba.apply_mamba, tmamba.apply_mamba),
    "mlstm": (jxlstm.init_mlstm, jxlstm.apply_mlstm, txlstm.apply_mlstm),
    "slstm": (jxlstm.init_slstm, jxlstm.apply_slstm, txlstm.apply_slstm),
}


def _cfgs(kind, dtype, chunk=8):
    """(JAX config, port config) of one layer of ``kind``."""
    if kind == "mamba":
        kw = dict(MCFG, dtype=dtype)
        mc = dict(d_state=8, d_conv=4, expand=2, dt_rank=4, chunk=chunk)
        return (ModelConfig(**kw, mamba=MambaConfig(**mc)),
                tbase.ModelConfig(**kw, mamba=tbase.MambaConfig(**mc)))
    kw = dict(XCFG, dtype=dtype, layer_pattern=(kind,))
    return (ModelConfig(**kw, xlstm=XLSTMConfig(chunk=chunk)),
            tbase.ModelConfig(**kw, xlstm=tbase.XLSTMConfig(chunk=chunk)))


def _jctx(cfg, mode):
    return jtfm.Ctx(cfg=cfg, pcfg=JPC(), mesh=None, mode=mode,
                    positions=jnp.zeros((B, 1), jnp.int32), cache_len=None,
                    x_spec=P(None, None, None))


def _tctx(cfg, mode):
    return ttfm.Ctx(cfg=cfg, pcfg=TPC(), mode=mode,
                    positions=torch.zeros((B, 1), dtype=torch.int64),
                    cache_len=None, paged=None)


def _jcache(kind, cfg):
    dt = jnp.dtype(cfg.dtype)
    spec = {"mamba": lambda: jmamba.cache_spec_mamba(cfg, B, dt),
            "mlstm": lambda: jxlstm.cache_spec_mlstm(cfg, B, dt),
            "slstm": lambda: jxlstm.cache_spec_slstm(cfg, B)}[kind]()
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)


def _tcache(kind, cfg):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    spec = {"mamba": lambda: tmamba.cache_spec_mamba(cfg, B, dt),
            "mlstm": lambda: txlstm.cache_spec_mlstm(cfg, B, dt),
            "slstm": lambda: txlstm.cache_spec_slstm(cfg, B)}[kind]()
    return {k: torch.zeros(shape, dtype=d) for k, (shape, d) in spec.items()}


def _layer(kind, dtype, chunk=8):
    jcfg, tcfg = _cfgs(kind, dtype, chunk)
    init, _, _ = LAYERS[kind]
    pj, _ = split_tree(init(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype)))
    pt = _map(jax.tree.map(np.asarray, pj), lambda a: _to_tensor(a, "cpu"))
    return jcfg, tcfg, pj, pt


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    tol = 1e-5 * max(1.0, scale) if dtype == "float32" else 2e-2 * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err:.3g} > {tol:.3g}"


def _inputs(dtype, s=S, seed=1):
    x = (np.random.default_rng(seed).normal(size=(B, s, 32)) * 0.5).astype(
        np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_prefill_and_decode_match_jax(kind, dtype):
    jcfg, tcfg, pj, pt = _layer(kind, dtype)
    _, japply, tapply = LAYERS[kind]
    xj, xt = _inputs(dtype)
    yj, cj = japply(pj, xj, _jctx(jcfg, "prefill"), _jcache(kind, jcfg))
    yt, ct = tapply(pt, xt, _tctx(tcfg, "prefill"), _tcache(kind, tcfg))
    _close(yt, yj, dtype, f"{kind} prefill y")
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert ct[name].dtype == _tcache(kind, tcfg)[name].dtype
        _close(ct[name], cj[name], dtype, f"{kind} prefill state {name}")
    # one decode token continuing the prefill's state
    x1j, x1t = _inputs(dtype, s=1, seed=2)
    yj, cj = japply(pj, x1j, _jctx(jcfg, "decode"), cj)
    yt, ct = tapply(pt, x1t, _tctx(tcfg, "decode"), ct)
    _close(yt, yj, dtype, f"{kind} decode y")
    for name in cj:
        _close(ct[name], cj[name], dtype, f"{kind} decode state {name}")
    # train mode: no cache in, none out
    yj, _ = japply(pj, xj, _jctx(jcfg, "train"), None)
    yt, none = tapply(pt, xt, _tctx(tcfg, "train"), None)
    assert none is None
    _close(yt, yj, dtype, f"{kind} train y")


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_chunked_equals_stepwise(kind, chunk):
    """The chunked prefill form equals token-by-token decode (the JAX
    suite's tolerances: 2e-4 Mamba, 3e-3 mLSTM)."""
    _, tcfg, _, pt = _layer(kind, "float32", chunk)
    _, _, tapply = LAYERS[kind]
    x = torch.from_numpy((np.random.default_rng(1).normal(
        size=(B, 32, 32)) * 0.5).astype(np.float32))
    y_par, _ = tapply(pt, x, _tctx(tcfg, "train"), None)
    cache = _tcache(kind, tcfg)
    outs = []
    for t in range(32):
        y_t, cache = tapply(pt, x[:, t:t + 1], _tctx(tcfg, "decode"), cache)
        outs.append(y_t)
    tol = 2e-4 if kind == "mamba" else 3e-3
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=tol, atol=tol)


def test_slstm_decode_continues_train_state():
    _, tcfg, _, pt = _layer("slstm", "float32")
    x = torch.from_numpy((np.random.default_rng(1).normal(
        size=(B, 16, 32)) * 0.5).astype(np.float32))
    y_full, _ = txlstm.apply_slstm(pt, x, _tctx(tcfg, "train"), None)
    _, state = txlstm.apply_slstm(pt, x[:, :9], _tctx(tcfg, "prefill"),
                                  _tcache("slstm", tcfg))
    outs = []
    for t in range(9, 16):
        y_t, state = txlstm.apply_slstm(pt, x[:, t:t + 1],
                                        _tctx(tcfg, "decode"), state)
        outs.append(y_t)
    np.testing.assert_allclose(y_full[:, 9:].numpy(),
                               torch.cat(outs, 1).numpy(), rtol=2e-4,
                               atol=2e-4)


def test_slstm_emits_bf16_rounded_h_in_f32():
    """The sLSTM scan rounds each emitted h to bf16 whatever the model's
    dtype: every f32 output is a bf16 value."""
    _, tcfg, _, pt = _layer("slstm", "float32")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 5, 32)).astype(np.float32))
    y, _ = txlstm.apply_slstm(pt, x, _tctx(tcfg, "train"), None)
    assert torch.equal(y, y.to(torch.bfloat16).float())


def test_softplus_is_jax_above_the_threshold():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.5, 20.0, 20.5, 40.0],
                 np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tmamba.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("glu,act", [(True, "gelu"), (True, "silu"),
                                     (False, "gelu")])
def test_dense_ffn_matches_jax(glu, act, dtype):
    kw = dict(MCFG, dtype=dtype, glu=glu, act=act, layer_pattern=("attn",))
    jcfg, tcfg = ModelConfig(**kw), tbase.ModelConfig(**kw)
    pj, _ = split_tree(jtfm.init_dense_ffn(jax.random.PRNGKey(0), jcfg,
                                           jnp.dtype(dtype)))
    if not glu:       # non-zero biases, so their cast and add are checked
        pj = dict(pj, b1=pj["b1"] + 0.1, b2=pj["b2"] - 0.05)
    pt = _map(jax.tree.map(np.asarray, pj), lambda a: _to_tensor(a, "cpu"))
    assert sorted(pt) == sorted(ttfm.init_dense_ffn(
        tcfg, torch.float32, torch.Generator().manual_seed(0), "cpu"))
    xj, xt = _inputs(dtype, s=3)
    yj = jtfm.apply_dense_ffn(pj, xj, _jctx(jcfg, "prefill"))
    yt = ttfm.apply_dense_ffn(pt, xt, _tctx(tcfg, "prefill"))
    assert yt.dtype == xt.dtype
    _close(yt, yj, dtype, "dense ffn")
