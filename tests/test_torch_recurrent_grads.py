"""PyTorch port vs the JAX package: the recurrent mixers' backward.

* ``jax.grad`` of the JAX Mamba, mLSTM and sLSTM layers in train mode
  against autograd through the port's, at chunk 4, 8 and 32 (sLSTM has
  no chunk): x and every parameter leaf within 1e-4 x max|ref| (f32; the
  two packages scan in other orders: JAX's ``associative_scan`` against
  the port's doubling scan);
* the per-chunk (and per-step) checkpoints of train mode change no
  gradient: the same layer without them (prefill mode, no cache) gives
  the same output and grads, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_recurrent import LAYERS, _jctx, _layer, _tctx

torch.set_num_threads(1)


def _grads_close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, f"{what}: max err {err:.3g} > 1e-4 x {scale:.3g}"


def _layer_inputs(seed=1, s=32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, s, 32)) * 0.5).astype(np.float32)
    ct = rng.normal(size=(2, s, 32)).astype(np.float32)
    return x, ct


@pytest.mark.parametrize("kind,chunk", [
    ("mamba", 4), ("mamba", 8), ("mamba", 32),
    ("mlstm", 4), ("mlstm", 8), ("mlstm", 32), ("slstm", 8)])
def test_layer_grads_match_jax(kind, chunk):
    """grads of sum(layer(x) * ct) for x and every parameter leaf."""
    jcfg, tcfg, pj, pt = _layer(kind, "float32", chunk)
    _, japply, tapply = LAYERS[kind]
    x, ct = _layer_inputs()

    def jloss(p, x_):
        y, _ = japply(p, x_, _jctx(jcfg, "train"), None)
        return jnp.sum(y.astype(jnp.float32) * ct)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in pt.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = tapply(tp, tx, _tctx(tcfg, "train"), None)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    _grads_close(tx.grad, gx, f"{kind} dx")
    assert sorted(tp) == sorted(gp)
    for name, t in tp.items():
        _grads_close(t.grad, gp[name], f"{kind} d{name}")


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_chunk_checkpoints_change_no_grad(kind):
    """Train mode checkpoints each chunk (sLSTM: each step); prefill mode
    without a cache runs the same forward without them."""
    _, tcfg, _, pt = _layer(kind, "float32", 8)
    apply = LAYERS[kind][2]
    x, ct = _layer_inputs(seed=3)
    out = {}
    for mode in ("train", "prefill"):
        tp = {k: v.clone().requires_grad_() for k, v in pt.items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, _ = apply(tp, tx, _tctx(tcfg, mode), None)
        (y.float() * torch.from_numpy(ct)).sum().backward()
        out[mode] = (y.detach(), tx.grad, {k: v.grad for k, v in tp.items()})
    assert torch.equal(out["train"][0], out["prefill"][0])
    assert torch.equal(out["train"][1], out["prefill"][1])
    for name, g in out["train"][2].items():
        assert torch.equal(g, out["prefill"][2][name]), name
