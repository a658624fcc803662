"""PyTorch port vs the JAX package: block-wise int8/fp8 quantization and
the quantized branches of the expert kernels and paged attention.

* ``quant.core``: ``quantize_blockwise`` (int8 and fp8, payloads compared
  bit for bit as uint8 views) and ``quantize_rows`` against
  ``repro.quant.core``; f32 scales at rtol 1e-6 (they come out equal).
* The plain versions of the quantized ``esffn_glu``, ``esffn_mlp``,
  ``esmm`` (both orientations, bias and none, an empty expert, a
  non-square tile grid) and ``paged_attention`` (int8 pools, a window, a
  softcap) against the Pallas kernels in interpret mode, within a share
  of max|ref| (outputs reach ~15 here): f32 1e-5 (summation order only);
  bf16 2e-2, the limit ``chip_smoke.py`` holds the kernels to: g, u and
  z round to bf16 after f32 sums taken in another order, so a rounding
  can land one ulp apart and carry through the activation, the down
  product and the output's own rounding (1 output ulp at max|ref| seen).
* The quantized autograd ops (``ops.esmm``, ``ops.esffn_glu`` and
  ``ops.esffn_mlp`` given scales: dX, d_gate, db) against ``jax.grad`` of
  the JAX ops, f32 at 1e-5 x max|ref|; ``hexa_moe_ffn`` on quantized
  params against JAX's.
* The CUDA argument checks of each quantized wrapper, which raise before
  anything is built.

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds their 8-bit
branches against these plain versions there."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import espec as jespec
from repro.core import reindex as jri
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels.esffn import esffn_glu_pallas, esffn_mlp_pallas
from repro.kernels.esmm import esmm_pallas
from repro.quant import core as jq
from repro_torch.core import espec as tespec
from repro_torch.core import reindex as tri
from repro_torch.kernels import esffn as tesffn
from repro_torch.kernels import esmm as tesmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.quant import core as tq

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

MODES = ["int8", "fp8"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}         # x max|ref|
GRAD_TOL = 1e-5                                   # x max|ref|, f32
N, D, F, E, K = 9, 32, 64, 4, 2                   # tile 16: 2 x 4 grids


def _t(a):
    """numpy (incl. ml_dtypes bf16/fp8) or jax array -> torch tensor."""
    from repro_torch.convert import _to_tensor
    return _to_tensor(np.asarray(a), "cpu")


def _np(t):
    return t.float().numpy()


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def _bits(a):
    """The raw bytes of an 8-bit payload, jax or torch."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _quant(w, mode, tile=16):
    """The same weights quantized by both packages (asserted equal)."""
    jqq, js = jq.quantize_blockwise(jnp.asarray(w), mode=mode, tile=tile)
    tqq, ts = tq.quantize_blockwise(torch.from_numpy(w), mode=mode,
                                    tile=tile)
    np.testing.assert_array_equal(_bits(tqq), _bits(jqq))
    return (jqq, js), (tqq, ts)


# ---------------------------------------------------------------------------
# quant.core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,tile,dtype", [
    ((3, 64, 32), 16, "float32"),     # 4 x 2 grid of 16 x 16 tiles
    ((2, 40, 24), 128, "float32"),    # tiles clamped to the dims
    ((2, 256, 128), 128, "float32"),  # the served 128 x 128 tiles
    ((2, 64, 32), 16, "bfloat16"),    # bf16 weights, as served
    ((2, 2, 48, 16), 16, "float32"),  # leading period axis
])
def test_quantize_blockwise_bitwise(mode, shape, tile, dtype):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape) * rng.uniform(0.01, 5.0, size=shape[:1] +
                                             (1,) * (len(shape) - 1))
    w.reshape(-1)[:3] = 0.0                       # exact zeros and a tie
    w = w.astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    jqq, js = jq.quantize_blockwise(jnp.asarray(w), mode=mode, tile=tile)
    tqq, ts = tq.quantize_blockwise(_t(w), mode=mode, tile=tile)
    assert tqq.dtype == tq.QUANT_FORMATS[mode][0] and tqq.shape == w.shape
    np.testing.assert_array_equal(_bits(tqq), _bits(jqq))
    assert ts.dtype == torch.float32 and ts.shape == js.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tq.dequantize_blockwise(tqq, ts).numpy(),
        np.asarray(jq.dequantize_blockwise(jqq, js)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_cast_rounding_matches_on_ties_and_extremes(mode):
    """The cast's round to nearest even and the clip at +-Q: every block
    holds +-Q, so its scale is exactly 1 and each half-step value is a tie
    of the rounding (int8: between integers; fp8: between e4m3 codes too);
    one all-zero block takes the 1e-30 floor of the scale."""
    qmax = tq.QUANT_FORMATS[mode][1]
    halves = (np.arange(-2 * qmax, 2 * qmax + 1) / 2).astype(np.float32)
    w = np.resize(halves, (1, 32, 128)).astype(np.float32)
    w[0, 0::16, 0::16] = qmax
    w[0, 1::16, 1::16] = -qmax
    w[0, 16:, 64:] = 0.0                     # all-zero blocks at tile <= 64
    for tile in (16, 64, 128):
        (jqq, js), (tqq, ts) = _quant(w, mode, tile)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(5, 7, 3, 16)) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero row
    for xx in (x, x.astype(ml_dtypes.bfloat16)):
        jr, js = jq.quantize_rows(jnp.asarray(xx))
        tr, ts = tq.quantize_rows(_t(xx))
        assert tr.dtype == torch.int8 and ts.shape == x.shape[:-1]
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)
        np.testing.assert_array_equal(
            tq.dequantize_rows(tr, ts).numpy(),
            np.asarray(jq.dequantize_rows(jr, js)))


def test_helpers_match_jax():
    for shape, tile in (((4, 256, 384), 128), ((2, 40, 24), 128),
                        ((8, 96, 16), 32)):
        assert tq.block_tiles(shape, tile) == jq.block_tiles(shape, tile)
    with pytest.raises(ValueError):
        tq.block_tiles((200, 128), 128)
    assert tq.scale_block_dims((256, 128), (2, 1), (128, 128)) == \
        jq.scale_block_dims((256, 128), (2, 1), (128, 128)) == (1, 1)
    with pytest.raises(ValueError):
        tq.scale_block_dims((384, 128), (4, 1), (128, 128))   # tile 96
    rng = np.random.default_rng(2)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    (jqq, js), (tqq, ts) = _quant(w[None], "int8")
    np.testing.assert_array_equal(
        tq.dequant_tile(tqq[0], ts[0]).numpy(),
        np.asarray(jq.dequant_tile(jqq[0], js[0])))
    assert tq.quant_bits("none") == jq.quant_bits("none") == 16
    assert tq.quant_bits("fp8") == jq.quant_bits("fp8") == 8
    assert tq.EXPERT_WEIGHT_KEYS == jq.EXPERT_WEIGHT_KEYS
    ffn = {"router": torch.ones(32, 4), "w1": torch.from_numpy(
        rng.normal(size=(4, 32, 48)).astype(np.float32)),
        "b1": torch.zeros(4, 48)}
    qffn = tq.quantize_ffn(ffn, tile=16)
    assert set(qffn) == {"router", "w1", "w1_scale", "b1"}
    assert set(tq.ffn_scales(qffn)) == {"w1_scale"}
    assert tq.ffn_scales(ffn) is None
    assert tq.quantize_ffn(qffn) is not qffn and \
        tq.quantize_ffn(qffn)["w1"] is qffn["w1"]   # already quantized


# ---------------------------------------------------------------------------
# the quantized kernels' plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _layout(pattern, blk, seed=1, n=N):
    """Routing with empty experts ("empty": every copy on experts 0 and 2)
    or a spread load, built by both packages."""
    rng = np.random.default_rng(seed)
    if pattern == "empty":
        idx = np.stack([np.zeros(n), np.full(n, 2)], 1)
    else:
        idx = np.stack([rng.permutation(n) % E, (rng.permutation(n) + 1) % E],
                       1)
    idx = idx.astype(np.int32)
    gates = rng.random((n, K)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), E, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), E,
                           blk)
    return jr, tr


def _glu_weights(seed, mode):
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=s) * 0.3).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return [_quant(w, mode) for w in ws]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["empty", "spread"])
def test_esffn_glu_plain_matches_pallas(mode, dtype, pattern):
    blk = 8
    jr, tr = _layout(pattern, blk)
    qs = _glu_weights(3, mode)
    x = np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = esffn_glu_pallas(
        jnp.asarray(x, jdt), jr.row_token, jr.row_gate, jr.block_expert,
        *(j[0] for j, _ in qs), w_scales=tuple(j[1] for j, _ in qs),
        interpret=True)
    got = tesffn.esffn_glu(
        _t(x).to(getattr(torch, dtype)), tr.row_token, tr.row_gate,
        tr.block_expert, *(t[0] for _, t in qs),
        w_scales=tuple(t[1] for _, t in qs))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    assert (_np(got)[np.asarray(jr.row_gate) == 0] == 0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("biases", [True, False])
def test_esffn_mlp_plain_matches_pallas(mode, dtype, biases):
    blk = 8
    jr, tr = _layout("spread", blk, seed=5)
    rng = np.random.default_rng(6)
    (j1, t1), (j2, t2) = (_quant((rng.normal(size=s) * 0.3).astype(
        np.float32), mode) for s in ((E, D, F), (E, F, D)))
    b1, b2 = ((rng.normal(size=s) * 0.3).astype(np.float32) if biases
              else None for s in ((E, F), (E, D)))
    x = rng.normal(size=(N, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jb = [None if b is None else jnp.asarray(b) for b in (b1, b2)]
    tb = [None if b is None else torch.from_numpy(b) for b in (b1, b2)]
    want = esffn_mlp_pallas(jnp.asarray(x, jdt), jr.row_token, jr.row_gate,
                            jr.block_expert, j1[0], jb[0], j2[0], jb[1],
                            w_scales=(j1[1], j2[1]), interpret=True)
    got = tesffn.esffn_mlp(_t(x).to(getattr(torch, dtype)), tr.row_token,
                           tr.row_gate, tr.block_expert, t1[0], tb[0], t2[0],
                           tb[1], w_scales=(t1[1], t2[1]))
    _close(got, want, dtype)


# (K, N, tile): the 2 x 4 / 4 x 2 grids and a one-tile grid (tile clamped)
ESMM_SHAPES = [(32, 64, 16), (64, 32, 16), (32, 64, 128)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kn", ESMM_SHAPES)
def test_esmm_plain_matches_pallas(mode, dtype, transpose_rhs, bias, kn):
    k, n, tile = kn
    blk = 8
    jr, tr = _layout("empty", blk, seed=7)        # experts 1 and 3 empty
    rng = np.random.default_rng(8)
    xs = np.array(jri.gather_rows(jnp.asarray(
        rng.normal(size=(N, k)).astype(np.float32)), jr.row_token))
    w = (rng.normal(size=(E, n, k) if transpose_rhs else (E, k, n)) * 0.3
         ).astype(np.float32)
    (jw, js), (tw, ts) = _quant(w, mode, tile)
    b = (rng.normal(size=(E, n)) * 0.3).astype(np.float32) if bias else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = esmm_pallas(jnp.asarray(xs, jdt), jw,
                       None if b is None else jnp.asarray(b),
                       jr.block_expert, w_scales=js,
                       transpose_rhs=transpose_rhs, bm=blk, bn=min(128, n),
                       bk=min(128, k), interpret=True)
    got = tesmm.esmm(torch.from_numpy(xs).to(tdt), tw,
                     None if b is None else torch.from_numpy(b),
                     tr.block_expert, w_scales=ts,
                     transpose_rhs=transpose_rhs)
    assert got.dtype == tdt and got.shape == (jr.num_rows, n)
    _close(got, want, dtype)


def test_esmm_transposed_scale_grid_misses():
    """A scale grid read on the wrong axes (the transpose of a non-square
    grid) must miss: the layout test that tiny square grids cannot give."""
    k, n = 64, 32
    jr, tr = _layout("spread", 8, seed=9)
    rng = np.random.default_rng(10)
    xs = torch.from_numpy(rng.normal(size=(jr.num_rows, k)).astype(
        np.float32))
    w = (rng.normal(size=(E, k, n)) * rng.uniform(
        0.1, 10, size=(1, k, 1))).astype(np.float32)
    _, (tw, ts) = _quant(w, "int8")
    assert ts.shape == (E, 4, 2)
    good = tesmm.esmm(xs, tw, None, tr.block_expert, w_scales=ts)
    wrong = tesmm.esmm_plain(xs, tw, None, tr.block_expert,
                             w_scales=ts.transpose(1, 2).reshape(E, 4, 2))
    ref = tesmm.esmm_plain(xs, tq.dequantize_blockwise(tw, ts), None,
                           tr.block_expert)
    np.testing.assert_allclose(_np(good), _np(ref), rtol=0, atol=1e-5)
    assert np.abs(_np(wrong) - _np(ref)).max() > 0.1 * np.abs(_np(ref)).max()


def _paged_case(seed=0):
    b, hq, hkv, hd, page, maxp = 4, 4, 2, 16, 8, 6
    rng = np.random.default_rng(seed)
    npages = 1 + b * maxp
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    kp = (rng.normal(size=(npages, page, hkv, hd)) * 2).astype(np.float32)
    vp = rng.normal(size=(npages, page, hkv, hd)).astype(np.float32)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp).astype(np.int32)
    table[2, 0] = table[1, 0]
    lengths = np.array([0, maxp * page, 13, 30], np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (7, 0.0),
                                            (None, 5.0), (11, 3.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_int8_matches_pallas_and_ref(window, softcap, dtype):
    q, kp, vp, table, lengths = _paged_case()
    jk, jks = jq.quantize_rows(jnp.asarray(kp))
    jv, jvs = jq.quantize_rows(jnp.asarray(vp))
    tk, tks = tq.quantize_rows(torch.from_numpy(kp))
    tv, tvs = tq.quantize_rows(torch.from_numpy(vp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(window=window, softcap=softcap)
    jargs = (jnp.asarray(q, jdt), jk, jv, jnp.asarray(table),
             jnp.asarray(lengths))
    got = tpa.paged_attention(torch.from_numpy(q).to(tdt), tk, tv,
                              torch.from_numpy(table),
                              torch.from_numpy(lengths), k_scale=tks,
                              v_scale=tvs, **kw)
    assert got.dtype == tdt and (_np(got)[0] == 0).all()
    pallas = jpa.paged_attention_pallas(*jargs, k_scale=jks, v_scale=jvs,
                                        interpret=True, **kw)
    ref = jpa.paged_attention_ref(*jargs, k_scale=jks, v_scale=jvs, **kw)
    for want in (pallas, ref):
        _close(got, want, dtype)


# ---------------------------------------------------------------------------
# gradients of the quantized ops vs jax.grad
# ---------------------------------------------------------------------------

def _grad_close(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_esmm_q_grads_match_jax(transpose_rhs, bias):
    blk, k, n = 8, 32, 64
    jr, tr = _layout("empty", blk, seed=11)
    rng = np.random.default_rng(12)
    xs = rng.normal(size=(jr.num_rows, k)).astype(np.float32)
    w = (rng.normal(size=(E, n, k) if transpose_rhs else (E, k, n)) * 0.3
         ).astype(np.float32)
    (jw, js), (tw, ts) = _quant(w, "int8")
    b = (rng.normal(size=(E, n)) * 0.3).astype(np.float32)
    # the cotangent an op gets in use: 0 on padding rows (their combine
    # gate is 0), where the JAX blocked ESS and the port's (the Pallas
    # kernel's, by padded_counts) would sum other things
    ct = rng.normal(size=(jr.num_rows, n)).astype(np.float32)
    ct *= (np.asarray(jr.row_gate) != 0)[:, None]

    def jloss(xs_, b_):
        y = jops.esmm(xs_, jw, b_ if bias else None, jr.block_expert,
                      jr.padded_counts, w_scales=js,
                      transpose_rhs=transpose_rhs, impl="blocked")
        return jnp.sum(y * ct)

    jdx, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xs),
                                               jnp.asarray(b))
    xs_t = torch.from_numpy(xs).requires_grad_()
    b_t = torch.from_numpy(b).requires_grad_()
    y = tops.esmm(xs_t, tw, b_t if bias else None, tr.block_expert,
                  tr.padded_counts, w_scales=ts, transpose_rhs=transpose_rhs)
    (y * torch.from_numpy(ct)).sum().backward()
    _grad_close(xs_t.grad, jdx, "dX")
    if bias:
        _grad_close(b_t.grad, jdb, "db")
    assert not tw.requires_grad and not ts.requires_grad


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pattern", ["empty", "spread"])
def test_esffn_glu_q_grads_match_jax(mode, pattern):
    blk = 8
    jr, tr = _layout(pattern, blk, seed=13)
    qs = _glu_weights(14, mode)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ct = rng.normal(size=(jr.num_rows, D)).astype(np.float32)

    def jloss(x_, gate_):
        y = jops.esffn_glu(x_, jr.row_token, gate_, jr.block_expert,
                           jr.padded_counts, *(j[0] for j, _ in qs),
                           scales=tuple(j[1] for j, _ in qs), impl="blocked")
        return jnp.sum(y * ct)

    jdx, jdg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jr.row_gate)
    x_t = torch.from_numpy(x).requires_grad_()
    gate_t = tr.row_gate.clone().requires_grad_()
    y = tops.esffn_glu(x_t, tr.row_token, gate_t, tr.block_expert,
                       tr.padded_counts, *(t[0] for _, t in qs),
                       scales=tuple(t[1] for _, t in qs))
    (y * torch.from_numpy(ct)).sum().backward()
    _grad_close(x_t.grad, jdx, "dX")
    _grad_close(gate_t.grad, jdg, "d_gate")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("biases", [True, False])
def test_esffn_mlp_q_grads_match_jax(mode, biases):
    blk = 8
    jr, tr = _layout("spread", blk, seed=16)
    rng = np.random.default_rng(17)
    (j1, t1), (j2, t2) = (_quant((rng.normal(size=s) * 0.3).astype(
        np.float32), mode) for s in ((E, D, F), (E, F, D)))
    b1 = (rng.normal(size=(E, F)) * 0.3).astype(np.float32)
    b2 = (rng.normal(size=(E, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ct = rng.normal(size=(jr.num_rows, D)).astype(np.float32)

    def jloss(x_, gate_, b1_, b2_):
        y = jops.esffn_mlp(x_, jr.row_token, gate_, jr.block_expert,
                           jr.padded_counts, j1[0], b1_ if biases else None,
                           j2[0], b2_ if biases else None,
                           scales=(j1[1], j2[1]), act="gelu", impl="blocked")
        return jnp.sum(y * ct)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jr.row_gate, jnp.asarray(b1), jnp.asarray(b2))
    x_t = torch.from_numpy(x).requires_grad_()
    gate_t = tr.row_gate.clone().requires_grad_()
    b1_t = torch.from_numpy(b1).requires_grad_()
    b2_t = torch.from_numpy(b2).requires_grad_()
    y = tops.esffn_mlp(x_t, tr.row_token, gate_t, tr.block_expert,
                       tr.padded_counts, t1[0], b1_t if biases else None,
                       t2[0], b2_t if biases else None, scales=(t1[1], t2[1]),
                       act="gelu")
    (y * torch.from_numpy(ct)).sum().backward()
    _grad_close(x_t.grad, jg[0], "dX")
    _grad_close(gate_t.grad, jg[1], "d_gate")
    if biases:
        _grad_close(b1_t.grad, jg[2], "db1")
        _grad_close(b2_t.grad, jg[3], "db2")


@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_hexa_moe_ffn_quantized_matches_jax(glu, fused, mode):
    """Routing, the quantized expert FFN and the combine, with the
    '<name>_scale' leaves of ``quantize_ffn`` detected by both packages;
    the router's grad flows (the payloads are frozen)."""
    rng = np.random.default_rng(18)
    keys = (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D))
            ) if glu else (("w1", (E, D, F)), ("w2", (E, F, D)))
    w = {k: (rng.normal(size=s) * 0.3).astype(np.float32) for k, s in keys}
    if not glu:
        w["b1"] = (rng.normal(size=(E, F)) * 0.3).astype(np.float32)
        w["b2"] = (rng.normal(size=(E, D)) * 0.3).astype(np.float32)
    w["router"] = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
    jp = jq.quantize_ffn({k: jnp.asarray(v) for k, v in w.items()},
                         mode=mode, tile=16)
    tp = tq.quantize_ffn({k: torch.from_numpy(v) for k, v in w.items()},
                         mode=mode, tile=16)
    assert set(tp) == set(jp)
    for k in tp:
        np.testing.assert_array_equal(_bits(tp[k]) if k in dict(keys)
                                      else tp[k].numpy(),
                                      _bits(jp[k]) if k in dict(keys)
                                      else np.asarray(jp[k]))
    x = rng.normal(size=(N, D)).astype(np.float32)
    act = "silu" if glu else "gelu"
    kw = dict(num_experts=E, top_k=K, act=act, glu=glu, blk=8)

    def jloss(router):
        out = jespec.hexa_moe_ffn(jnp.asarray(x), {**jp, "router": router},
                                  impl="blocked", fused=fused, **kw)
        return jnp.sum(out.y * out.y) + out.aux_loss, out.y

    (_, jy), jgr = jax.value_and_grad(jloss, has_aux=True)(jp["router"])
    router = tp["router"].clone().requires_grad_()
    out = tespec.hexa_moe_ffn(torch.from_numpy(x), {**tp, "router": router},
                              **kw) if fused else None
    if not fused:
        from repro_torch.core.routing import route
        r = route(torch.from_numpy(x), router, K)
        ri = tri.build_reindex(r.expert_idx, r.gates, E, 8)
        if glu:
            y = tespec.moe_glu(torch.from_numpy(x), ri, tp["w_gate"],
                               tp["w_up"], tp["w_down"], act=act,
                               scales=(tp["w_gate_scale"], tp["w_up_scale"],
                                       tp["w_down_scale"]), fused=False)
        else:
            y = tespec.moe_mlp(torch.from_numpy(x), ri, tp["w1"], tp["b1"],
                               tp["w2"], tp["b2"], act=act,
                               scales=(tp["w1_scale"], tp["w2_scale"]),
                               fused=False)
        out = tespec.MoEOutput(y=y, aux_loss=r.aux_loss, z_loss=r.z_loss,
                               router=r)
    np.testing.assert_allclose(out.y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5)
    ((out.y * out.y).sum() + out.aux_loss).backward()
    _grad_close(router.grad, jgr, "d_router")


# ---------------------------------------------------------------------------
# the CUDA wrappers' argument checks (before any build)
# ---------------------------------------------------------------------------

def _glu_args(mode="int8", e=E, d=D, f=F):
    dt = tq.QUANT_FORMATS[mode][0]
    x = torch.zeros((N, d))
    layout = (torch.zeros(32, dtype=torch.int32), torch.zeros(32),
              torch.zeros(4, dtype=torch.int32))
    ws = (torch.zeros((e, d, f), dtype=dt), torch.zeros((e, d, f), dtype=dt),
          torch.zeros((e, f, d), dtype=dt))
    scales = (torch.ones((e, d // 16, f // 16)),
              torch.ones((e, d // 16, f // 16)),
              torch.ones((e, f // 16, d // 16)))
    return x, layout, ws, scales


@pytest.mark.parametrize("mode", MODES)
def test_quantized_esffn_argument_checks(mode):
    x, layout, ws, scales = _glu_args(mode)
    check = tesffn._check_cuda_args
    assert check(x, *layout, *ws, "silu", scales) == (N, D, F, 32, 8)
    assert check(x.bfloat16(), *layout, *ws, "silu", scales)[-1] == 8
    bad = [
        ((x, *layout, *(w.float() for w in ws), "silu", scales), TypeError),
        ((x, *layout, ws[0], ws[1], ws[2].view(torch.uint8), "silu",
          scales), TypeError),                         # mixed payloads
        ((x.half(), *layout, *ws, "silu", scales), TypeError),
        ((x, *layout, *ws, "silu", (scales[0].double(),) + scales[1:]),
         TypeError),
        ((x, *layout, *ws, "silu", scales[:2]), ValueError),
        ((x, *layout, *ws, "silu", (scales[0][:, :, :3],) + scales[1:]),
         ValueError),                                  # 3 does not tile 4
        ((x, *layout, *ws, "silu", (scales[0][:3],) + scales[1:]),
         ValueError),                                  # expert count
    ]
    for args, err in bad:
        with pytest.raises(err):
            check(*args)
    # a quant tile that does not divide the TPU kernel's 128-wide F block
    x2, layout2, ws2, _ = _glu_args(mode, f=384)
    odd = (torch.ones((E, 2, 4)), torch.ones((E, 2, 4)),
           torch.ones((E, 4, 2)))                      # F tiles of 96
    with pytest.raises(ValueError, match="does not divide"):
        check(x2, *layout2, *ws2, "silu", odd)
    # the same checks on the MLP form
    mcheck = tesffn._check_mlp_cuda_args
    w1, w2 = ws[0], ws[2]
    b1, b2 = torch.zeros((E, F)), torch.zeros((E, D))
    assert mcheck(x, *layout, w1, b1, w2, b2, "gelu", (scales[0],
                                                       scales[2]))[-1] == 8
    with pytest.raises(TypeError):
        mcheck(x, *layout, w1.float(), b1, w2.float(), b2, "gelu",
               (scales[0], scales[2]))
    with pytest.raises(ValueError):
        mcheck(x, *layout, w1, b1, w2, b2, "gelu",
               (scales[0][:, :1, :3], scales[2]))


@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_esmm_argument_checks_and_route(transpose):
    e, k, n = 3, 64, 32
    xs = torch.zeros((256, k), dtype=torch.bfloat16)
    be = torch.zeros(2, dtype=torch.int32)
    w = torch.zeros((e, n, k) if transpose else (e, k, n), dtype=torch.int8)
    s = torch.ones((e,) + tuple(d // 16 for d in w.shape[1:]))
    assert tesmm._check_cuda_args(xs, w, None, be, transpose, s) == \
        (256, k, n, 128)
    # bf16 at blk 128 takes wgmma, but 8-bit weights take the 3xTF32
    # tensor-core route (dequantized to f32 as they are staged)
    assert tesmm._route(torch.bfloat16, 128, k, n) == "wgmma"
    assert tesmm._route(torch.bfloat16, 128, k, n, quantized=True) == \
        "mma_tf32x3"
    with pytest.raises(TypeError, match="int8"):
        tesmm._check_cuda_args(xs, w.bfloat16(), None, be, transpose, s)
    with pytest.raises(ValueError):
        tesmm._check_cuda_args(xs, w, None, be, transpose, s[:, :1, :3])
    with pytest.raises(ValueError):                # scales of another W
        tesmm._check_cuda_args(xs, w, None, be, transpose, s[:2])
    with pytest.raises(TypeError):
        tesmm._check_cuda_args(xs.half(), w, None, be, transpose, s)
    wide = torch.zeros((e, 64, 384) if not transpose else (e, 384, 64),
                       dtype=torch.int8)
    odd = torch.ones((e, 1, 4) if not transpose else (e, 4, 1))  # tile 96
    with pytest.raises(ValueError, match="does not divide"):
        tesmm._check_cuda_args(xs, wide, None, be, transpose, odd)


def test_quantized_paged_attention_argument_checks():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _paged_case())
    (kq, ks), (vq, vs) = tq.quantize_rows(kp), tq.quantize_rows(vp)
    assert tpa._check_cuda_args(q, kq, vq, table, lengths, ks, vs) == \
        (4, 4, 2, 16, 8, 6)
    assert tpa._check_cuda_args(q.bfloat16(), kq, vq, table, lengths, ks,
                                vs)[0] == 4
    with pytest.raises(TypeError):                 # int8 pools, no scales
        tpa._check_cuda_args(q, kq, vq, table, lengths)
    with pytest.raises(TypeError):                 # scales, float pools
        tpa._check_cuda_args(q, kp, vp, table, lengths, ks, vs)
    with pytest.raises(ValueError):                # one scale pool only
        tpa._check_cuda_args(q, kq, vq, table, lengths, ks, None)
    with pytest.raises(ValueError):
        tpa._check_cuda_args(q, kq, vq, table, lengths, ks[:, :4], vs)
    with pytest.raises(TypeError):
        tpa._check_cuda_args(q, kq, vq, table, lengths, ks.double(), vs)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpa.paged_attention(q.to("meta"), kq.to("meta"), vq.to("meta"),
                            table.to("meta"), lengths.to("meta"),
                            k_scale=ks.to("meta"), v_scale=vs.to("meta"))
