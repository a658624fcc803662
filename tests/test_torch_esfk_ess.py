"""PyTorch port vs the JAX package: ESFK and ESS, the bias-grad kernels of
the MLP expert FFN's backward.

The port's plain versions (what its wrappers run on a CPU tensor) are
held against the Pallas kernels ``esfk_pallas`` and ``ess_pallas`` in
interpret mode on the same numpy inputs and the same expert-sorted layout,
in f32 and bf16, with exact zeros for experts that got no rows; then the
biased ``ops.esmm``'s backward (dX, dW and db) against ``jax.grad`` of the
JAX op, and ``ops.set_fused_backward(False)`` (ESTMM + ESS, the paper's
Fig. 12 ablation) against the fused ESFK path.

Tolerances: f32 at 2e-5, bf16 at 2e-2 (both sum in f32 in another order;
the bf16 inputs are the same numbers on both sides), as in
``tests/test_kernels.py``; grads at 1e-5 x max|ref|. The fused and unfused
backward compute the same sums in the same order here, so they agree
exactly.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
them against these plain versions there. Here their wrappers' argument
checks are tested."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reindex as jri
from repro.kernels import ops as jops
from repro.kernels.esfk import esfk_pallas
from repro.kernels.ess import ess_pallas
from repro_torch.core import reindex as tri
from repro_torch.kernels import esfk as tesfk
from repro_torch.kernels import ess as tess
from repro_torch.kernels import estmm as testmm
from repro_torch.kernels import ops as tops

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

SHAPES = [
    # (n_tokens, k, E, D1, D2, blk)
    (32, 1, 2, 16, 32, 8),
    (64, 2, 4, 32, 16, 16),
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
    return jr, tr


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.array(a, np.float32)).to(
                getattr(torch, dtype)))


def _rows(jr, d, seed, live_only=True):
    """(Np, d) sorted rows, zero on padding rows (as the backward's
    operands are) unless ``live_only`` is False."""
    x = np.random.default_rng(seed).normal(size=(jr.num_rows, d))
    if live_only:
        x = x * (np.asarray(jr.row_gate) != 0)[:, None]
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esfk_plain_matches_pallas(shape, dtype):
    n, k, e, d1, d2, blk = shape
    jr, tr = _layout(n, k, e, blk, seed=1)
    x1_j, x1_t = _pair(_rows(jr, d1, 2), dtype)
    x2_j, x2_t = _pair(_rows(jr, d2, 3), dtype)
    dw_j, db_j = esfk_pallas(x1_j, x2_j, jr.block_expert, jr.padded_counts,
                             bm=blk, interpret=True)
    dw, db = tesfk.esfk(x1_t, x2_t, tr.block_expert, tr.padded_counts)
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (e, d1, d2) and db.shape == (e, d2)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL[dtype])
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **TOL[dtype])
    # the ops-level entry is the same function
    dw_o, db_o = tops.esfk(x1_t, x2_t, tr.block_expert, tr.padded_counts)
    assert torch.equal(dw_o, dw) and torch.equal(db_o, db)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ess_plain_matches_pallas(shape, dtype):
    n, k, e, _, d, blk = shape
    jr, tr = _layout(n, k, e, blk, seed=4)
    x_j, x_t = _pair(_rows(jr, d, 5), dtype)
    want = ess_pallas(x_j, jr.block_expert, jr.padded_counts, bm=blk,
                      interpret=True)
    got = tess.ess(x_t, tr.block_expert, tr.padded_counts)
    assert got.dtype == torch.float32 and got.shape == (e, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    assert torch.equal(tops.ess(x_t, tr.block_expert, tr.padded_counts), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_experts_exactly_zero(dtype):
    """Experts with no routed rows get exactly-0 dW and db from both
    kernels, also the last expert, which owns the all-padding tail blocks;
    the rows here are nonzero on padding rows too, so only the count mask
    keeps the empty experts at 0."""
    n, k, e, d1, d2, blk = 16, 2, 4, 16, 32, 8
    idx = np.stack([np.zeros(n), np.full(n, 2)], 1).astype(np.int32)
    jr, tr = _layout(n, k, e, blk, idx=idx)
    counts = tr.counts.numpy()
    assert (counts[[1, 3]] == 0).all() and (counts[[0, 2]] > 0).all()
    x1_j, x1_t = _pair(_rows(jr, d1, 6, live_only=False), dtype)
    x2_j, x2_t = _pair(_rows(jr, d2, 7, live_only=False), dtype)
    dw, db = tesfk.esfk(x1_t, x2_t, tr.block_expert, tr.padded_counts)
    s = tess.ess(x2_t, tr.block_expert, tr.padded_counts)
    for i in (1, 3):
        assert (dw[i] == 0).all() and (db[i] == 0).all() and (s[i] == 0).all()
    assert (dw[0] != 0).any() and (db[2] != 0).any()
    dw_j, db_j = esfk_pallas(x1_j, x2_j, jr.block_expert, jr.padded_counts,
                             bm=blk, interpret=True)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL[dtype])
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(ess_pallas(
        x2_j, jr.block_expert, jr.padded_counts, bm=blk, interpret=True)),
        **TOL[dtype])


def _esmm_case(transpose_rhs, seed=8):
    n, k, e, d1, d2, blk = 24, 2, 4, 16, 24, 8
    idx = np.random.default_rng(seed).integers(0, e - 1, size=(n, k))
    jr, tr = _layout(n, k, e, blk, idx=idx.astype(np.int32))  # e-1 empty
    rng = np.random.default_rng(seed + 1)
    xs = _rows(jr, d1, seed + 2)
    w = (rng.normal(size=(e, d2, d1) if transpose_rhs else (e, d1, d2))
         * 0.3).astype(np.float32)
    b = (rng.normal(size=(e, d2)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(jr.num_rows, d2)).astype(np.float32)
    return jr, tr, xs, w, b, ct


def _torch_esmm_grads(tr, xs, w, b, ct, transpose_rhs):
    ts = [torch.from_numpy(a).requires_grad_() for a in (xs, w, b)]
    y = tops.esmm(*ts, tr.block_expert, tr.padded_counts,
                  transpose_rhs=transpose_rhs)
    (y * torch.from_numpy(ct)).sum().backward()
    return [t.grad for t in ts]


def test_biased_esmm_backward_matches_jax():
    """The biased ESMM's backward: dX by ESMM, (dW, db) by ESFK."""
    jr, tr, xs, w, b, ct = _esmm_case(False)

    def jloss(xs_, w_, b_):
        y = jops.esmm(xs_, w_, b_, jr.block_expert, jr.padded_counts,
                      impl="pallas")
        return jnp.sum(y * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (xs, w, b)))
    assert tops._FUSED_BACKWARD          # the fused path is the default
    got = _torch_esmm_grads(tr, xs, w, b, ct, False)
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(g.numpy(), wt, rtol=0,
                                   atol=1e-5 * np.abs(wt).max())
    assert (got[1][-1] == 0).all() and (got[2][-1] == 0).all()


def test_transposed_esmm_bias_grad_is_refused_as_in_jax():
    """A transposed ESMM runs forward with a bias, but neither package
    defines its bias grad (the JAX bwd rule's db has the wrong shape)."""
    jr, tr, xs, w, b, ct = _esmm_case(True)

    def jloss(xs_, w_, b_):
        return jnp.sum(jops.esmm(xs_, w_, b_, jr.block_expert,
                                 jr.padded_counts, transpose_rhs=True,
                                 impl="pallas"))

    with pytest.raises(ValueError, match="shapes do not match"):
        jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (xs, w, b)))
    with pytest.raises(NotImplementedError, match="transposed ESMM"):
        _torch_esmm_grads(tr, xs, w, b, ct, True)
    y_j = jops.esmm(*map(jnp.asarray, (xs, w, b)), jr.block_expert,
                    jr.padded_counts, transpose_rhs=True, impl="pallas")
    y_t = tops.esmm(*map(torch.from_numpy, (xs, w, b)), tr.block_expert,
                    tr.padded_counts, transpose_rhs=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL["float32"])


def test_unfused_backward_gives_the_fused_grads(monkeypatch):
    """``set_fused_backward(False)`` takes ESTMM + ESS instead of ESFK (the
    launch counts show which ran; on the CPU they count the plain
    versions' calls through the wrappers) and gives the same grads."""
    jr, tr, xs, w, b, ct = _esmm_case(False, seed=11)
    calls = {"esfk": 0, "estmm": 0, "ess": 0}
    for name, mod in (("esfk", tesfk), ("estmm", testmm), ("ess", tess)):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(mod, name, counted)
    fused = _torch_esmm_grads(tr, xs, w, b, ct, False)
    assert calls == {"esfk": 1, "estmm": 0, "ess": 0}
    try:
        tops.set_fused_backward(False)
        unfused = _torch_esmm_grads(tr, xs, w, b, ct, False)
    finally:
        tops.set_fused_backward(True)
    assert calls == {"esfk": 1, "estmm": 1, "ess": 1}
    for a, c in zip(fused, unfused):
        assert torch.equal(a, c)
    # without a bias grad to take, the backward needs ESTMM only
    ts = [torch.from_numpy(a).requires_grad_() for a in (xs, w)]
    y = tops.esmm(*ts, torch.from_numpy(b), tr.block_expert,
                  tr.padded_counts)
    (y * torch.from_numpy(ct)).sum().backward()
    assert calls == {"esfk": 1, "estmm": 2, "ess": 1}
    assert torch.equal(ts[1].grad, fused[1])


def test_esfk_and_ess_argument_checks():
    """What the CUDA wrappers check before a launch (on CPU tensors, which
    they would otherwise hand to the plain versions)."""
    x1, x2 = torch.zeros((32, 16)), torch.zeros((32, 24))
    be, pc = torch.zeros(4, dtype=torch.int32), torch.zeros(
        3, dtype=torch.int32)
    assert testmm._check_cuda_args(x1, x2, be, pc, "esfk") == (32, 16, 24, 3)
    with pytest.raises(TypeError, match="esfk takes"):
        testmm._check_cuda_args(x1, x2.bfloat16(), be, pc, "esfk")
    assert tess._check_cuda_args(x2, be, pc) == (32, 24, 3)
    assert tess._check_cuda_args(x2.bfloat16(), torch.zeros(
        1, dtype=torch.int32), pc) == (32, 24, 3)   # any block size
    bad = [((x2[:, :, None], be, pc), ValueError),
           ((x2.half(), be, pc), TypeError),
           ((x2, be.long(), pc), TypeError),
           ((x2, be, pc[:, None]), TypeError),
           ((x2, torch.zeros(5, dtype=torch.int32), pc), ValueError),
           ((x2, be, torch.zeros(0, dtype=torch.int32)), ValueError),
           ((x2.t().contiguous().t(), be, pc), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            tess._check_cuda_args(*args)
    for fn, args in ((tesfk.esfk, (x1, x2, be, pc)),
                     (tess.ess, (x2, be, pc))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(*[t.to("meta") for t in args])
