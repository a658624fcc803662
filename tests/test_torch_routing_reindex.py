"""PyTorch port vs the JAX package: top-k routing and the expert-sorted
re-index layout (paper Alg. 1). The same numpy inputs go through both.

Integer outputs (expert choices and every re-index map) must match
bitwise; float outputs (gates, aux and z losses) to 1e-6 in f32, the
difference two f32 softmax implementations leave."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reindex as jri
from repro.core import routing as jrt
from repro_torch.core import reindex as tri
from repro_torch.core import routing as trt

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

INT_FIELDS = ("row_id", "row_token", "block_expert", "counts",
              "padded_counts")

# (n, d, e, k, blk, ties): ties duplicates router columns so logits tie
# exactly; e >> n*k leaves most experts empty.
ROUTE_CASES = [
    (7, 16, 8, 2, 8, False),
    (12, 16, 8, 2, 16, True),
    (3, 8, 16, 2, 8, False),       # 6 copies over 16 experts: empty experts
    (5, 8, 6, 3, 16, True),
]


def _inputs(n, d, e, ties, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, e)).astype(np.float32)
    if ties:
        w[:, 1::2] = w[:, 0:1]      # every odd expert ties expert 0
    return x, w


def _check_reindex(jr, tr, gate_atol=0.0):
    """Integer maps bitwise; row_gate bitwise when both layouts were built
    from the same gates, else to the gates' own tolerance."""
    for name in INT_FIELDS:
        a, b = np.asarray(getattr(jr, name)), getattr(tr, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(np.asarray(jr.row_gate), tr.row_gate.numpy(),
                               rtol=0, atol=gate_atol)


@pytest.mark.parametrize("case", ROUTE_CASES)
@pytest.mark.parametrize("mode", ["norm_topk", "softmax_after_topk", "masked"])
def test_route_then_reindex_matches_jax(case, mode):
    n, d, e, k, blk, ties = case
    x, w = _inputs(n, d, e, ties)
    kw = dict(norm_topk=mode == "norm_topk",
              softmax_after_topk=mode == "softmax_after_topk")
    valid = None
    if mode == "masked":
        valid = np.arange(n) % 3 != 1
        kw["valid_mask"] = jnp.asarray(valid)
    jr = jrt.route(jnp.asarray(x), jnp.asarray(w), k, **kw)
    if valid is not None:
        kw["valid_mask"] = torch.from_numpy(valid)
    tr = trt.route(torch.from_numpy(x), torch.from_numpy(w), k, **kw)

    np.testing.assert_array_equal(np.asarray(jr.expert_idx),
                                  tr.expert_idx.numpy())
    np.testing.assert_allclose(np.asarray(jr.gates), tr.gates.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(jr.aux_loss), float(tr.aux_loss),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(jr.z_loss), float(tr.z_loss),
                               rtol=1e-6, atol=1e-6)
    if ties and valid is None:
        # equal scores resolve to the lower expert id first
        g, c = tr.gates.numpy(), tr.expert_idx.numpy()
        tied = g[:, :-1] == g[:, 1:]
        assert tied.any()
        assert (c[:, :-1][tied] < c[:, 1:][tied]).all()

    _check_reindex(jri.build_reindex(jr.expert_idx, jr.gates, e, blk),
                   tri.build_reindex(tr.expert_idx, tr.gates, e, blk),
                   gate_atol=1e-6)


@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("pattern", ["skewed", "one_expert", "spread"])
def test_reindex_bitwise_from_given_choices(blk, pattern):
    """The layout from fixed expert choices: a skewed load (groups spanning
    several blocks), every copy on one expert (all other experts empty, a
    long all-padding tail) and a spread load."""
    n, k, e = 11, 2, 6
    rng = np.random.default_rng(blk)
    if pattern == "skewed":
        idx = np.where(rng.random((n, k)) < 0.7, 2, rng.integers(0, e, (n, k)))
    elif pattern == "one_expert":
        idx = np.full((n, k), 4)
    else:
        idx = rng.integers(0, e, (n, k))
    idx = idx.astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), e, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), e,
                           blk)
    assert tr.num_rows == tri.padded_rows(n, k, e, blk) == jr.num_rows
    _check_reindex(jr, tr)


def test_gather_and_scatter_rows_match_jax():
    """Sentinel rows gather zeros; the scatter-add drops them."""
    rng = np.random.default_rng(3)
    n, k, e, blk, d = 6, 2, 4, 8, 5
    idx = rng.integers(0, e, (n, k)).astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    jr = jri.build_reindex(jnp.asarray(idx), jnp.asarray(gates), e, blk)
    tr = tri.build_reindex(torch.from_numpy(idx), torch.from_numpy(gates), e,
                           blk)
    js = jri.gather_rows(jnp.asarray(x), jr.row_token)
    ts = tri.gather_rows(torch.from_numpy(x), tr.row_token)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    ys = rng.normal(size=js.shape).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jri.combine_scatter(jnp.asarray(ys), jr, n)),
        tri.combine_scatter(torch.from_numpy(ys), tr, n).numpy(),
        rtol=1e-6, atol=1e-6)
