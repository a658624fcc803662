"""PyTorch port vs the JAX package: the fused GLU expert FFN.

The port's plain version (what its wrapper runs on a CPU tensor) is held
against the Pallas kernel ``esffn_glu_pallas`` in interpret mode and the
JAX ``blocked`` implementation, on layouts with empty experts, all-padding
tail blocks and sentinel rows; then the layers above it (``ops``,
``espec.moe_glu``, ``espec.hexa_moe_ffn``, ``moe_layer``) against theirs.

Tolerances: f32 at atol 1e-5 (summation order only). bf16 at rtol 2e-2
+ atol 2e-2 (outputs up to ~5 here): g and u round to bf16 (8 mantissa
bits) after f32 sums taken in another order, so a rounding can land one
bf16 ulp (0.4-0.8 %) apart and propagate through act(g) * u, the down
product and the final rounding of the output.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against this plain version there. Here its argument checks are tested."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import espec as jespec
from repro.core import reindex as jri
from repro.kernels import ops as jops
from repro.kernels.esffn import esffn_glu_pallas
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


def _weights(seed=0, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.normal(size=(d, e)) * 0.5).astype(np.float32),
        "w_gate": (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32),
        "w_up": (rng.normal(size=(e, d, f)) * 0.3).astype(np.float32),
        "w_down": (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32),
    }


def _layout(pattern, blk, seed=1):
    """Routing with empty experts ("empty": every copy on experts 0 and 2)
    or a spread load; the static layout always ends in all-padding blocks
    whose rows are sentinels."""
    rng = np.random.default_rng(seed)
    if pattern == "empty":
        idx = np.stack([np.zeros(N), np.full(N, 2)], 1)
    else:
        idx = np.stack([rng.permutation(N) % E, (rng.permutation(N) + 1) % E], 1)
    idx = idx.astype(np.int32)
    gates = rng.random((N, K)).astype(np.float32)
    return idx, gates


def _to(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["empty", "spread"])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_matches_pallas_interpret(dtype, pattern, blk, act):
    w = _weights()
    idx, gates = _layout(pattern, blk)
    x = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), E, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), E,
                           blk)
    tail = np.asarray(jr.row_gate).reshape(-1, blk)
    assert (tail[-1] == 0).all(), "layout should end in an all-padding block"
    if pattern == "empty":
        assert (np.asarray(jr.counts) == 0).sum() == 2

    wj = [jnp.asarray(w[k], jdt) for k in ("w_gate", "w_up", "w_down")]
    want = esffn_glu_pallas(jnp.asarray(x, jdt), jr.row_token, jr.row_gate,
                            jr.block_expert, *wj, act=act, interpret=True)
    got = tesffn.esffn_glu(_to(x, dtype), tr.row_token, tr.row_gate,
                           tr.block_expert,
                           *[_to(w[k], dtype) for k in ("w_gate", "w_up",
                                                        "w_down")], act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == (jr.num_rows, D)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    # padding rows (sentinels and all-padding blocks) are exactly zero
    pad = np.asarray(jr.row_gate) == 0
    assert (_np(got)[pad] == 0).all()
    if dtype == "float32":
        blocked = jops.esffn_glu(jnp.asarray(x), jr.row_token, jr.row_gate,
                                 jr.block_expert, jr.padded_counts, *wj,
                                 act=act, impl="blocked")
        np.testing.assert_allclose(_np(got), np.asarray(blocked),
                                   **TOL[dtype])


@pytest.mark.parametrize("blk", [8, 16])
def test_ops_and_moe_glu_match_jax(blk):
    w = _weights(3)
    idx, gates = _layout("spread", blk, seed=4)
    x = np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), E, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), E,
                           blk)
    wj = [jnp.asarray(w[k]) for k in ("w_gate", "w_up", "w_down")]
    wt = [torch.from_numpy(w[k]) for k in ("w_gate", "w_up", "w_down")]
    ys = tops.esffn_glu(torch.from_numpy(x), tr.row_token, tr.row_gate,
                        tr.block_expert, tr.padded_counts, *wt)
    np.testing.assert_allclose(
        ys.numpy(), np.asarray(jops.esffn_glu(
            jnp.asarray(x), jr.row_token, jr.row_gate, jr.block_expert,
            jr.padded_counts, *wj, impl="pallas")), rtol=0, atol=1e-5)
    y = tespec.moe_glu(torch.from_numpy(x), tr, *wt)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jespec.moe_glu(jnp.asarray(x), jr, *wj,
                                             impl="pallas", fused=True)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_topk,softmax_after_topk",
                         [(True, False), (False, True)])
def test_hexa_moe_ffn_and_moe_layer_match_jax(norm_topk, softmax_after_topk):
    w = _weights(6)
    x = np.random.default_rng(7).normal(size=(2, 5, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, act="silu", glu=True, blk=8,
              norm_topk=norm_topk, softmax_after_topk=softmax_after_topk)
    jout = jespec.hexa_moe_ffn(jnp.asarray(x.reshape(-1, D)),
                               {k: jnp.asarray(v) for k, v in w.items()},
                               impl="pallas", fused=True, **kw)
    tout = tespec.hexa_moe_ffn(torch.from_numpy(x.reshape(-1, D)),
                               {k: torch.from_numpy(v) for k, v in w.items()},
                               **kw)
    np.testing.assert_allclose(tout.y.numpy(), np.asarray(jout.y), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(tout.aux_loss), float(jout.aux_loss),
                               rtol=1e-6)

    ms = dict(num_experts=E, top_k=K, act="silu", glu=True,
              norm_topk=norm_topk, softmax_after_topk=softmax_after_topk)
    jy, jaux, jz = jmp.moe_layer(
        jnp.asarray(x), jmp.MoEParams(**{k: jnp.asarray(v)
                                         for k, v in w.items()}),
        jmp.MoEStatic(**ms), JPC(blk=8, impl="pallas", mode="hybrid"), None,
        x_spec=None)
    ty, taux, tz = tmp.moe_layer(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()},
        tmp.MoEStatic(**ms), TPC(blk=8))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-6)


def _args(np_rows=32, nblk=4, dtype=torch.float32):
    x = torch.zeros((N, D), dtype=dtype)
    return (x, torch.zeros(np_rows, dtype=torch.int32),
            torch.zeros(np_rows, dtype=torch.float32),
            torch.zeros(nblk, dtype=torch.int32),
            torch.zeros((E, D, F), dtype=dtype),
            torch.zeros((E, D, F), dtype=dtype),
            torch.zeros((E, F, D), dtype=dtype))


def test_kernel_argument_checks():
    """What the CUDA wrapper checks before a launch (on CPU tensors, which
    it would otherwise hand to the plain version)."""
    assert tesffn._check_cuda_args(*_args(), "silu") == (N, D, F, 32, 8)
    assert tesffn._check_cuda_args(*_args(256, 2), "gelu")[-1] == 128
    for bad, err in ((_args(16, 4), ValueError),      # blk 4
                     (_args(512, 2), ValueError),     # blk 256
                     (_args(36, 3), ValueError),      # blk 12
                     (_args(dtype=torch.float16), TypeError)):
        with pytest.raises(err):
            tesffn._check_cuda_args(*bad, "silu")
    with pytest.raises(ValueError):
        tesffn._check_cuda_args(*_args(), "swish")
    # block scales go with 8-bit payloads (tests/test_torch_quant.py holds
    # the quantized branch itself)
    with pytest.raises(TypeError, match="int8"):
        tesffn.esffn_glu(*_args(), w_scales=tuple(
            torch.ones((E, 1, 1)) for _ in range(3)))


# The GLU route of every case chip_smoke.py runs (qwen3-moe-30b-a3b's
# experts: D 2048, F 768), and the edges of the route rule:
# (dtype, blk, D, F, 8-bit weights, route).
GLU_ROUTES = [
    (torch.bfloat16, 16, 2048, 768, False, "stream"),   # serve decode/prefill
    (torch.float32, 16, 2048, 768, False, "stream"),    # f32 serve, phase 7
    (torch.bfloat16, 16, 2048, 768, True, "stream"),    # 8-bit serve
    (torch.float32, 16, 2048, 768, True, "stream"),
    (torch.bfloat16, 128, 2048, 768, False, "wgmma"),   # LM train, N 4096
    (torch.bfloat16, 128, 2048, 768, True, "stream"),   # 8-bit at blk 128
    (torch.float32, 128, 2048, 768, False, "stream"),
    (torch.bfloat16, 64, 2048, 768, False, "wgmma"),
    (torch.bfloat16, 32, 2048, 768, False, "stream"),
    (torch.bfloat16, 128, 2044, 768, False, "stream"),  # D not % 8
    (torch.bfloat16, 128, 2048, 764, False, "stream"),  # F not % 8
    (torch.bfloat16, 128, 24, 40, False, "wgmma"),
]


@pytest.mark.parametrize("dtype,blk,d,f,quantized,route", GLU_ROUTES)
def test_glu_route_rule(dtype, blk, d, f, quantized, route):
    assert tesffn._route(dtype, blk, d, f, quantized) == route


def test_glu_route_counts_start_at_zero():
    assert set(tesffn.esffn_glu.launches_by_route) == {"stream", "wgmma"}
    assert all(isinstance(v, int)
               for v in tesffn.esffn_glu.launches_by_route.values())


def _glu_args(np_rows, nblk, d, f, dtype=torch.bfloat16):
    x = torch.zeros((N, d), dtype=dtype)
    return (x, torch.zeros(np_rows, dtype=torch.int32),
            torch.zeros(np_rows, dtype=torch.float32),
            torch.zeros(nblk, dtype=torch.int32),
            torch.zeros((E, d, f), dtype=dtype),
            torch.zeros((E, d, f), dtype=dtype),
            torch.zeros((E, f, d), dtype=dtype))


def _misaligned(t):
    """t's values at a base address 2 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return buf[1:].view(t.shape)


def test_glu_route_refusals():
    """What each route refuses before a launch: both copy x and weight
    rows in 16-byte pieces (aligned base addresses); the stream route
    takes D and F multiples of 16 and 8-bit column tiles of 8 or more,
    the wgmma route D and F multiples of 8."""
    check = tesffn._check_cuda_args
    # wgmma at D 24, F 40 (multiples of 8, not of 16) is taken
    assert check(*_glu_args(128, 1, 24, 40), "silu") == (N, 24, 40, 128, 128)
    # the same widths on the stream route (blk 16) are refused
    with pytest.raises(ValueError, match="multiples of 16"):
        check(*_glu_args(32, 2, 24, 40), "silu")
    with pytest.raises(ValueError, match="multiples of 16"):
        check(*_glu_args(32, 2, 32, 40, torch.float32), "silu")
    # misaligned operands: the weights and x on both routes (stream, then
    # wgmma)
    for np_rows, nblk in ((32, 2), (128, 1)):
        for i in (0, 4):
            args = list(_glu_args(np_rows, nblk, 32, 48))
            args[i] = _misaligned(args[i])
            with pytest.raises(ValueError, match="16-byte aligned"):
                check(*args, "silu")
    # 8-bit weights whose column quant tile is 4 wide are refused
    x, rt, rg, be, *_ = _glu_args(32, 2, 32, 48)
    ws = (torch.zeros((E, 32, 48), dtype=torch.int8),
          torch.zeros((E, 32, 48), dtype=torch.int8),
          torch.zeros((E, 48, 32), dtype=torch.int8))
    good = (torch.ones((E, 2, 3)), torch.ones((E, 2, 3)),
            torch.ones((E, 3, 2)))                   # tiles 16 x 16
    assert check(x, rt, rg, be, *ws, "silu", good) == (N, 32, 48, 32, 16)
    narrow = (torch.ones((E, 2, 12)), torch.ones((E, 2, 12)),
              torch.ones((E, 3, 8)))                 # column tiles of 4
    with pytest.raises(ValueError, match="multiples of 8"):
        check(x, rt, rg, be, *ws, "silu", narrow)
