"""PyTorch port vs the JAX package: ESMM and ESTMM.

The port's plain versions (what its wrappers run on a CPU tensor) are held
against the Pallas kernels ``esmm_pallas`` and ``estmm_pallas`` in
interpret mode on the same numpy inputs and the same expert-sorted layout
(built by each package from the same routing), in both weight
orientations, with and without a bias, in f32 and bf16, at the
tolerances of ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2: both sum
in f32 in another order, and a bf16 output may round one ulp apart).

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
them against these plain versions there. Here their wrappers' argument
checks are tested."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reindex as jri
from repro.kernels.esmm import esmm_pallas
from repro.kernels.estmm import estmm_pallas
from repro_torch.core import reindex as tri
from repro_torch.kernels import esmm as tesmm
from repro_torch.kernels import estmm as testmm
from repro_torch.kernels import ops as tops

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

SHAPES = [
    # (n_tokens, k, E, D1, D2, blk)
    (32, 1, 2, 16, 32, 8),
    (64, 2, 4, 32, 16, 16),
    (48, 2, 3, 16, 16, 8),
    (16, 4, 8, 32, 64, 8),   # many empty experts likely
]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _layout(n, k, e, blk, seed=0, idx=None):
    rng = np.random.default_rng(seed)
    if idx is None:
        idx = rng.integers(0, e, size=(n, k)).astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), e, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), e,
                           blk)
    np.testing.assert_array_equal(tr.block_expert.numpy(),
                                  np.asarray(jr.block_expert))
    np.testing.assert_array_equal(tr.padded_counts.numpy(),
                                  np.asarray(jr.padded_counts))
    return jr, tr


def _sorted_rows(jr, n, d, seed):
    """(Np, d) sorted rows: token rows gathered through the layout, zero on
    sentinel rows (as the backward's operands are)."""
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return np.asarray(jri.gather_rows(jnp.asarray(x), jr.row_token))


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.array(a, np.float32)).to(
                getattr(torch, dtype)))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_esmm_plain_matches_pallas(shape, dtype, transpose_rhs, bias):
    n, k, e, d1, d2, blk = shape
    jr, tr = _layout(n, k, e, blk)
    rng = np.random.default_rng(1)
    xs_j, xs_t = _pair(_sorted_rows(jr, n, d1, 2), dtype)
    wshape = (e, d2, d1) if transpose_rhs else (e, d1, d2)
    w_j, w_t = _pair(rng.normal(size=wshape) * 0.3, dtype)
    b_j, b_t = (_pair(rng.normal(size=(e, d2)) * 0.3, dtype) if bias
                else (None, None))
    want = esmm_pallas(xs_j, w_j, b_j, jr.block_expert,
                       transpose_rhs=transpose_rhs, bm=blk, bn=min(128, d2),
                       bk=min(128, d1), interpret=True)
    got = tesmm.esmm(xs_t, w_t, b_t, tr.block_expert,
                     transpose_rhs=transpose_rhs)
    assert got.dtype == xs_t.dtype and got.shape == (jr.num_rows, d2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    # ops.esmm's forward is the same function
    got_op = tops.esmm(xs_t, w_t, b_t, tr.block_expert, tr.padded_counts,
                       transpose_rhs=transpose_rhs)
    assert torch.equal(got_op, got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estmm_plain_matches_pallas(shape, dtype):
    n, k, e, d1, d2, blk = shape
    jr, tr = _layout(n, k, e, blk, seed=3)
    x1_j, x1_t = _pair(_sorted_rows(jr, n, d1, 4), dtype)
    x2 = np.random.default_rng(5).normal(size=(jr.num_rows, d2))
    x2 = x2 * (np.asarray(jr.row_gate) != 0)[:, None]
    x2_j, x2_t = _pair(x2, dtype)
    want = estmm_pallas(x1_j, x2_j, jr.block_expert, jr.padded_counts,
                        bm=blk, interpret=True)
    got = testmm.estmm(x1_t, x2_t, tr.block_expert, tr.padded_counts)
    assert got.dtype == torch.float32 and got.shape == (e, d1, d2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    np.testing.assert_array_equal(
        got.numpy(), tops.estmm(x1_t, x2_t, tr.block_expert,
                                tr.padded_counts).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estmm_empty_expert_exactly_zero(dtype):
    """Experts with no routed rows get exactly-0 grads, also the last
    expert, which owns the all-padding tail blocks."""
    n, k, e, d1, d2, blk = 16, 2, 4, 16, 32, 8
    idx = np.stack([np.zeros(n), np.full(n, 2)], 1).astype(np.int32)
    jr, tr = _layout(n, k, e, blk, idx=idx)
    counts = tr.counts.numpy()
    assert (counts[[1, 3]] == 0).all() and (counts[[0, 2]] > 0).all()
    # nonzero sentinel rows: only the mask keeps the empty experts at 0
    x1 = np.random.default_rng(6).normal(size=(jr.num_rows, d1))
    x2 = np.random.default_rng(7).normal(size=(jr.num_rows, d2))
    (x1_j, x1_t), (x2_j, x2_t) = _pair(x1, dtype), _pair(x2, dtype)
    got = testmm.estmm(x1_t, x2_t, tr.block_expert, tr.padded_counts)
    want = estmm_pallas(x1_j, x2_j, jr.block_expert, jr.padded_counts,
                        bm=blk, interpret=True)
    for i in (1, 3):
        assert (got[i] == 0).all()
    assert (got[0] != 0).any() and (got[2] != 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


def _esmm_args(np_rows=32, nblk=4, k=16, n=24, e=3, dtype=torch.float32,
               transpose=False, bias=False):
    w = torch.zeros((e, n, k) if transpose else (e, k, n), dtype=dtype)
    return (torch.zeros((np_rows, k), dtype=dtype), w,
            torch.zeros((e, n), dtype=dtype) if bias else None,
            torch.zeros(nblk, dtype=torch.int32), transpose)


def test_esmm_argument_checks():
    """What the CUDA wrapper checks before a launch (on CPU tensors, which
    it would otherwise hand to the plain version)."""
    assert tesmm._check_cuda_args(*_esmm_args()) == (32, 16, 24, 8)
    assert tesmm._check_cuda_args(*_esmm_args(transpose=True, bias=True)) \
        == (32, 16, 24, 8)
    assert tesmm._check_cuda_args(*_esmm_args(256, 2))[-1] == 128
    bad = [(_esmm_args(16, 4), ValueError),                  # blk 4
           (_esmm_args(512, 2), ValueError),                 # blk 256
           (_esmm_args(36, 3), ValueError),                  # blk 12
           (_esmm_args(dtype=torch.float16), TypeError)]
    xs, w, b, be, t = _esmm_args()
    bad += [((xs, w.transpose(1, 2), b, be, t), ValueError),  # K mismatch
            ((xs, w, torch.zeros(3, 5), be, t), ValueError),  # bias shape
            ((xs, w.bfloat16(), b, be, t), TypeError),        # mixed dtypes
            ((xs, w, b, be.long(), t), TypeError),
            ((xs, w.transpose(1, 2).contiguous().transpose(1, 2), b, be,
              t), ValueError)]                                # not contiguous
    for args, err in bad:
        with pytest.raises(err):
            tesmm._check_cuda_args(*args)
    with pytest.raises(NotImplementedError, match="quantization"):
        tesmm.esmm(xs, w, b, be, w_scales=torch.ones(3, 1, 1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tesmm.esmm(xs.to("meta"), w.to("meta"), None, be.to("meta"))


def test_estmm_argument_checks():
    x1, x2 = torch.zeros((32, 16)), torch.zeros((32, 24))
    be, pc = torch.zeros(4, dtype=torch.int32), torch.zeros(3,
                                                            dtype=torch.int32)
    assert testmm._check_cuda_args(x1, x2, be, pc) == (32, 16, 24, 3)
    bad = [((x1, x2[:16], be, pc), ValueError),
           ((x1, x2.bfloat16(), be, pc), TypeError),
           ((x1.half(), x2.half(), be, pc), TypeError),
           ((x1, x2, be, pc.long()), TypeError),
           ((x1, x2, torch.zeros(8, dtype=torch.int32), pc), ValueError),
           ((x1, x2, torch.zeros(3, dtype=torch.int32), pc), ValueError),
           ((x1.t().contiguous().t(), x2, be, pc), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            testmm._check_cuda_args(*args)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        testmm.estmm(x1.to("meta"), x2.to("meta"), be.to("meta"),
                     pc.to("meta"))


def test_bias_grads_belong_to_the_mlp_expert_slice():
    """ESFK (dW with db) and ESS compute the bias grads of the MLP-expert
    slice: the biased ESMM's backward gives db = the per-expert sum of dy;
    the bias-free ESMM backward does not need them."""
    x1 = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8) / 100
    be, pc = torch.zeros(2, dtype=torch.int32), torch.tensor(
        [16], dtype=torch.int32)
    dw, db = tops.esfk(x1, x1, be, pc)
    torch.testing.assert_close(dw, (x1.t() @ x1)[None])
    torch.testing.assert_close(db, x1.sum(0)[None])
    assert torch.equal(tops.ess(x1, be, pc), db)
    w = torch.zeros((1, 8, 8), requires_grad=True)
    b = torch.zeros((1, 8), requires_grad=True)
    y = tops.esmm(x1, w, b, be, pc)
    (y * x1).sum().backward()
    torch.testing.assert_close(b.grad, x1.sum(0)[None])
    w.grad = None
    y = tops.esmm(x1, w, b.detach(), be, pc)
    y.sum().backward()
    assert w.grad.shape == w.shape
