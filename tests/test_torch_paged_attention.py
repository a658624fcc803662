"""PyTorch port vs the JAX package: paged decode attention.

The port's plain version (what its wrapper runs on a CPU tensor) is held
against the Pallas kernel ``paged_attention_pallas`` in interpret mode and
the JAX ``paged_attention_ref``, over ragged lengths with an empty slot
(exact zeros), pages two slots share, windows and a tanh softcap.

Tolerances: f32 at atol 1e-5. bf16 at atol 2e-2 on outputs of magnitude
< ~2: the reference rounds the softmax probabilities to bf16 before the
value product where the Pallas kernel keeps them f32, and the output
rounds to bf16 (ulp 0.0078 at 1-2).

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against this plain version there. Here its argument checks are tested."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as tpa

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (b, hq, hkv, hd, page, maxp): GQA, MQA and kv == q layouts
CASES = [
    (4, 4, 2, 16, 8, 6),
    (3, 8, 1, 16, 4, 5),
    (5, 4, 4, 8, 16, 2),
]


def _case(case, seed=0):
    """Pools with a random page permutation per slot, slot 0 empty, slot 1
    full, and slot 2's first page shared with slot 1's."""
    b, hq, hkv, hd, page, maxp = case
    rng = np.random.default_rng(seed)
    npages = 1 + b * maxp
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    kp = rng.normal(size=(npages, page, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(npages, page, hkv, hd)).astype(np.float32)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp).astype(np.int32)
    table[2, 0] = table[1, 0]
    lengths = rng.integers(1, maxp * page + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = 0, maxp * page
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (7, 0.0),
                                            (None, 5.0), (11, 3.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_ref(case, window, softcap, dtype):
    q, kp, vp, table, lengths = _case(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(table), jnp.asarray(lengths))
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
             torch.from_numpy(lengths))
    got = tpa.paged_attention(*targs, window=window, softcap=softcap)
    assert got.dtype == tdt and got.shape == q.shape
    got = got.float().numpy()
    assert (got[0] == 0).all(), "an empty slot must give exact zeros"
    pallas = jpa.paged_attention_pallas(*jargs, window=window,
                                        softcap=softcap, interpret=True)
    ref = jpa.paged_attention_ref(*jargs, window=window, softcap=softcap)
    for want in (pallas, ref):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=TOL[dtype])
    if dtype == "float32":
        # the plain version IS the port of the reference
        np.testing.assert_allclose(
            tpa.paged_attention_ref(*targs, window=window,
                                    softcap=softcap).numpy(),
            np.asarray(ref), rtol=0, atol=1e-6)


def test_kernel_argument_checks():
    """What the CUDA wrapper checks before a launch."""
    q, kp, vp, table, lengths = (torch.from_numpy(a)
                                 for a in _case(CASES[0]))
    assert tpa._check_cuda_args(q, kp, vp, table, lengths) == (4, 4, 2, 16,
                                                                8, 6)
    with pytest.raises(TypeError):
        tpa._check_cuda_args(q, kp, vp, table.long(), lengths)
    with pytest.raises(TypeError):
        tpa._check_cuda_args(q.half(), kp.half(), vp.half(), table, lengths)
    with pytest.raises(ValueError):
        tpa._check_cuda_args(q, kp, vp[:, :, :1], table, lengths)
    with pytest.raises(ValueError):
        tpa._check_cuda_args(q, kp, vp, table, lengths[:2])
    with pytest.raises(TypeError, match="int8"):   # scales, float pools
        tpa.paged_attention(q, kp, vp, table, lengths, k_scale=kp[..., 0],
                            v_scale=vp[..., 0])
