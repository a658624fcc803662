"""PyTorch port vs the JAX package: the fused 2-MLP expert FFN (Swin-MoE's
expert body, ``act(x W1 + b1) W2 + b2``, gate-weighted).

The port's plain version (what its wrapper runs on a CPU tensor) is held
against the Pallas kernel ``esffn_mlp_pallas`` in interpret mode and the
JAX ``blocked`` implementation, on layouts with empty experts, all-padding
tail blocks and sentinel rows, with each bias present and absent; then
the autograd op ``ops.esffn_mlp`` (grads of x, the routing gates, W1, b1,
W2, b2) against ``jax.grad`` of the JAX op, and the layers above it
(``espec.moe_mlp`` fused and unfused, ``espec.hexa_moe_ffn(glu=False)``,
``moe_layer``) against theirs.

Tolerances: f32 at atol 1e-5 on outputs (summation order only) and 1e-5 x
max|ref| on grads. bf16 at rtol 2e-2 + atol 2e-2 on outputs (up to ~5
here): z rounds to bf16 after f32 sums taken in another order, so one
rounding can land a bf16 ulp (0.4-0.8 %) apart and carry through gelu,
the down product and the output's rounding.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against this plain version there. Here its argument checks are tested."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import espec as jespec
from repro.core import reindex as jri
from repro.kernels import ops as jops
from repro.kernels.esffn import esffn_mlp_pallas
from repro.parallel import moe_parallel as jmp
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch.core import espec as tespec
from repro_torch.core import reindex as tri
from repro_torch.kernels import esffn as tesffn
from repro_torch.kernels import ops as tops
from repro_torch.parallel import moe_parallel as tmp
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

N, D, F, E, K = 9, 16, 32, 4, 2
TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = 1e-5                                   # x max|ref|, f32
NAMES = ("w1", "b1", "w2", "b2")


def _weights(seed=0, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.normal(size=(d, e)) * 0.5).astype(np.float32),
        "w1": (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32),
        "b1": (rng.normal(size=(e, f)) * 0.3).astype(np.float32),
        "w2": (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32),
        "b2": (rng.normal(size=(e, d)) * 0.3).astype(np.float32),
    }


def _layout(pattern, blk, seed=1):
    """Routing with empty experts ("empty": every copy on experts 0 and 2)
    or a spread load; the static layout always ends in all-padding blocks
    whose rows are sentinels."""
    rng = np.random.default_rng(seed)
    if pattern == "empty":
        idx = np.stack([np.zeros(N), np.full(N, 2)], 1)
    else:
        idx = np.stack([rng.permutation(N) % E, (rng.permutation(N) + 1) % E],
                       1)
    idx = idx.astype(np.int32)
    gates = rng.random((N, K)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), E, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), E,
                           blk)
    return idx, gates, jr, tr


def _to(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _close_rel(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["empty", "spread"])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("biases", ["both", "none", "b1", "b2"])
def test_plain_matches_pallas_interpret(dtype, pattern, blk, biases):
    w = _weights()
    _, _, jr, tr = _layout(pattern, blk)
    x = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    tail = np.asarray(jr.row_gate).reshape(-1, blk)
    assert (tail[-1] == 0).all(), "layout should end in an all-padding block"
    if pattern == "empty":
        assert (np.asarray(jr.counts) == 0).sum() == 2
    keep = {"both": ("b1", "b2"), "none": (), "b1": ("b1",),
            "b2": ("b2",)}[biases]
    jdt = getattr(jnp, dtype)
    # weights in the compute dtype, biases in f32 (as init_swin has them)
    wj = [None if (k[0] == "b" and k not in keep) else
          jnp.asarray(w[k], jnp.float32 if k[0] == "b" else jdt)
          for k in NAMES]
    wt = [None if (k[0] == "b" and k not in keep) else
          _to(w[k], "float32" if k[0] == "b" else dtype) for k in NAMES]

    want = esffn_mlp_pallas(jnp.asarray(x, jdt), jr.row_token, jr.row_gate,
                            jr.block_expert, *wj, act="gelu", interpret=True)
    got = tesffn.esffn_mlp(_to(x, dtype), tr.row_token, tr.row_gate,
                           tr.block_expert, *wt, act="gelu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (jr.num_rows, D)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    # padding rows (sentinels and all-padding blocks) are exactly zero,
    # b2 included: it sits inside the gate product
    pad = np.asarray(jr.row_gate) == 0
    assert (_np(got)[pad] == 0).all()
    if dtype == "float32":
        blocked = jops.esffn_mlp(jnp.asarray(x), jr.row_token, jr.row_gate,
                                 jr.block_expert, jr.padded_counts, *wj,
                                 act="gelu", impl="blocked")
        np.testing.assert_allclose(_np(got), np.asarray(blocked), **TOL[dtype])


def test_b2_is_inside_the_gate_product():
    """out = (h W2 + b2) * gate: with W2 = 0 every live row is b2[e] * gate,
    not b2[e] + 0 * gate."""
    w = _weights(8)
    _, _, _, tr = _layout("spread", 8)
    x = np.random.default_rng(9).normal(size=(N, D)).astype(np.float32)
    out = tesffn.esffn_mlp(_to(x), tr.row_token, tr.row_gate,
                           tr.block_expert, _to(w["w1"]), _to(w["b1"]),
                           torch.zeros((E, F, D)), _to(w["b2"]))
    blk = tr.row_token.shape[0] // tr.block_expert.shape[0]
    rows_e = tr.block_expert.long().repeat_interleave(blk)
    want = _to(w["b2"])[rows_e] * tr.row_gate[:, None]
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("biases", [True, False])
def test_ops_esffn_mlp_grads_match_jax(blk, biases):
    """Grads of sum(esffn_mlp(...) * ct) for x, row_gate (through the
    re-index gather of the routing gates), W1, b1, W2 and b2: the
    flash-style recompute backward (ESMM recompute with b1, act's vjp,
    t = dys_w W2^T, d_gate with the dys_w . b2 term, (dW, db) by ESFK, dX
    by the transposed ESMM)."""
    w = _weights(3)
    idx, gates, _, _ = _layout("empty", blk, seed=4)
    x = np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)
    rng = np.random.default_rng(6)

    def jfn(x_, gates_, w1, b1, w2, b2):
        ri = jri.build_reindex(jnp.asarray(idx), gates_, E, blk)
        ys = jops.esffn_mlp(x_, ri.row_token, ri.row_gate, ri.block_expert,
                            ri.padded_counts, w1, b1 if biases else None, w2,
                            b2 if biases else None, act="gelu", impl="pallas")
        return ys, ri

    _, jr0 = jfn(jnp.asarray(x), jnp.asarray(gates),
                 *[jnp.asarray(w[k]) for k in NAMES])
    ct = rng.normal(size=(jr0.num_rows, D)).astype(np.float32)
    jloss = lambda *a: jnp.sum(jfn(*a)[0] * ct)  # noqa: E731
    jargs = [jnp.asarray(x), jnp.asarray(gates)] + [jnp.asarray(w[k])
                                                    for k in NAMES]
    want = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)

    targs = [_to(x).requires_grad_(), _to(gates).requires_grad_()] + [
        _to(w[k]).requires_grad_() for k in NAMES]
    xt, gt, w1, b1, w2, b2 = targs
    tr = tri.build_reindex(torch.from_numpy(idx), gt, E, blk)
    ys = tops.esffn_mlp(xt, tr.row_token, tr.row_gate, tr.block_expert,
                        tr.padded_counts, w1, b1 if biases else None, w2,
                        b2 if biases else None, act="gelu")
    (ys * torch.from_numpy(ct)).sum().backward()
    for name, t, g in zip(("x", "gates") + NAMES, targs, want):
        if name in ("b1", "b2") and not biases:
            assert t.grad is None
            continue
        _close_rel(t.grad, g, GRAD_TOL)
    # experts 1 and 3 got no rows: exactly-0 weight and bias grads
    for t in (w1, w2) + ((b1, b2) if biases else ()):
        assert (t.grad[[1, 3]] == 0).all()


@pytest.mark.parametrize("fused", [True, False])
def test_moe_mlp_matches_jax(fused):
    """``espec.moe_mlp``: fused (esffn_mlp) and unfused (two differentiable
    ESMMs with biases, gelu between, combine) forward and grads."""
    blk = 8
    w = _weights(7)
    idx, gates, _, _ = _layout("spread", blk, seed=8)
    x = np.random.default_rng(9).normal(size=(N, D)).astype(np.float32)
    ct = np.random.default_rng(10).normal(size=(N, D)).astype(np.float32)

    def jloss(x_, gates_, w1, b1, w2, b2):
        ri = jri.build_reindex(jnp.asarray(idx), gates_, E, blk)
        y = jespec.moe_mlp(x_, ri, w1, b1, w2, b2, act="gelu",
                           impl="pallas", fused=fused)
        return jnp.sum(y * ct), y

    jargs = [jnp.asarray(x), jnp.asarray(gates)] + [jnp.asarray(w[k])
                                                    for k in NAMES]
    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*jargs)
    targs = [_to(x).requires_grad_(), _to(gates).requires_grad_()] + [
        _to(w[k]).requires_grad_() for k in NAMES]
    xt, gt, *wt = targs
    tr = tri.build_reindex(torch.from_numpy(idx), gt, E, blk)
    y = tespec.moe_mlp(xt, tr, *wt, act="gelu", fused=fused)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL["float32"])
    (y * torch.from_numpy(ct)).sum().backward()
    for t, g in zip(targs, jg):
        _close_rel(t.grad, g, GRAD_TOL)


@pytest.mark.parametrize("top_k,norm_topk", [(1, True), (2, True),
                                             (2, False)])
def test_hexa_moe_ffn_and_moe_layer_mlp_match_jax(top_k, norm_topk):
    """Route + re-index + fused MLP FFN + combine, and ``moe_layer`` over a
    (B, S, D) activation: y, aux and z against the JAX layer."""
    w = _weights(11)
    x = np.random.default_rng(12).normal(size=(2, 8, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=top_k, act="gelu", glu=False, blk=8,
              norm_topk=norm_topk)
    jout = jespec.hexa_moe_ffn(jnp.asarray(x.reshape(16, D)),
                               {k: jnp.asarray(v) for k, v in w.items()},
                               impl="pallas", fused=True, **kw)
    tout = tespec.hexa_moe_ffn(_to(x.reshape(16, D)),
                               {k: _to(v) for k, v in w.items()}, **kw)
    np.testing.assert_allclose(_np(tout.y), np.asarray(jout.y),
                               **TOL["float32"])
    np.testing.assert_allclose(float(tout.aux_loss), float(jout.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tout.z_loss), float(jout.z_loss),
                               rtol=1e-6)

    ms_j = jmp.MoEStatic(num_experts=E, top_k=top_k, act="gelu", glu=False,
                         norm_topk=norm_topk)
    ms_t = tmp.MoEStatic(num_experts=E, top_k=top_k, act="gelu", glu=False,
                         norm_topk=norm_topk)
    jy, jaux, _ = jmp.moe_layer(
        jnp.asarray(x), jmp.MoEParams(**{k: jnp.asarray(v)
                                         for k, v in w.items()}),
        ms_j, JPC(blk=8, impl="pallas", fused_ffn=True), None, x_spec=None)
    ty, taux, _ = tmp.moe_layer(_to(x), {k: _to(v) for k, v in w.items()},
                                ms_t, TPC(blk=8))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_top1_gates_are_one_and_router_learns_from_aux_alone():
    """Top-1 with ``norm_topk``: every gate is p/p = 1, so the expert
    output does not depend on the router and its grad comes from the aux
    loss alone, as in the JAX layer. The port keeps that."""
    w = _weights(13)
    x = _to(np.random.default_rng(14).normal(size=(N, D)))
    params = {k: _to(v).requires_grad_() for k, v in w.items()}
    out = tespec.hexa_moe_ffn(x, params, num_experts=E, top_k=1, act="gelu",
                              glu=False, blk=8)
    live = out.router.gates
    assert torch.equal(live, torch.ones_like(live))
    (g_y,) = torch.autograd.grad(out.y.sum(), params["router"],
                                 retain_graph=True, allow_unused=True)
    assert g_y is None or float(g_y.abs().max()) < 1e-6
    (g_aux,) = torch.autograd.grad(out.aux_loss, params["router"])
    assert float(g_aux.abs().max()) > 0


def test_quantized_mlp_experts_raise():
    """Quantized MLP experts run (tests/test_torch_quant.py holds them to
    JAX); what raises is a half-quantized dict (no ``w2_scale``, as the
    JAX layer's lookup fails) and scales beside full-precision weights."""
    w = {k: _to(v) for k, v in _weights().items()}
    w["w1_scale"] = torch.ones((E, 1, 1))
    kw = dict(num_experts=E, top_k=K, act="gelu", glu=False, blk=8)
    with pytest.raises(KeyError, match="w2_scale"):
        tespec.hexa_moe_ffn(_to(np.zeros((N, D))), w, **kw)
    w["w2_scale"] = torch.ones((E, 1, 1))
    with pytest.raises(TypeError, match="int8"):
        tespec.hexa_moe_ffn(_to(np.zeros((N, D))), w, **kw)


def _mlp_args(np_rows=32, nblk=4, dtype=torch.float32, biases=True):
    x = torch.zeros((N, D), dtype=dtype)
    return [x, torch.zeros(np_rows, dtype=torch.int32),
            torch.zeros(np_rows), torch.zeros(nblk, dtype=torch.int32),
            torch.zeros((E, D, F), dtype=dtype),
            torch.zeros((E, F)) if biases else None,
            torch.zeros((E, F, D), dtype=dtype),
            torch.zeros((E, D)) if biases else None, "gelu"]


def test_esffn_mlp_argument_checks():
    """What the CUDA wrapper checks before a launch (on CPU tensors, which
    it would otherwise hand to the plain version)."""
    check = tesffn._check_mlp_cuda_args
    assert check(*_mlp_args()) == (N, D, F, 32, 8)
    assert check(*_mlp_args(biases=False)) == (N, D, F, 32, 8)
    assert check(*_mlp_args(256, 2))[-1] == 128
    # bf16 weights with f32 biases (init_swin's dtypes) are accepted
    assert check(*_mlp_args(dtype=torch.bfloat16))[-1] == 8

    def bad(i, v):
        a = _mlp_args()
        a[i] = v
        return a

    cases = [(_mlp_args(16, 4), ValueError),                   # blk 4
             (_mlp_args(512, 2), ValueError),                  # blk 256
             (_mlp_args(dtype=torch.float16), TypeError),
             (bad(4, torch.zeros((E, D + 1, F))), ValueError),  # W1 shape
             (bad(5, torch.zeros((E, D))), ValueError),         # b1 shape
             (bad(7, torch.zeros((E, F))), ValueError),         # b2 shape
             (bad(6, torch.zeros((E, F, D), dtype=torch.bfloat16)),
              TypeError),                                       # mixed
             (bad(1, torch.zeros(32, dtype=torch.int64)), TypeError),
             (bad(2, torch.zeros(16)), ValueError),             # gate len
             (bad(8, "swish"), ValueError),
             (bad(4, torch.zeros((E, F, D)).transpose(1, 2)), ValueError)]
    for args, err in cases:
        with pytest.raises(err):
            check(*args)
    a = _mlp_args()
    with pytest.raises(TypeError, match="int8"):   # scales, f32 weights
        tesffn.esffn_mlp(*a[:8], w_scales=(torch.ones((E, 1, 1)),) * 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tesffn.esffn_mlp(*[t.to("meta") if isinstance(t, torch.Tensor)
                           else t for t in a[:8]])
