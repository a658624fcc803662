"""PyTorch port vs the JAX package: flash attention (forward only).

The port's plain version (what ``flash_attention`` runs on a CPU tensor)
is held against the JAX ``flash_attention`` (the Pallas kernel in
interpret mode behind its GQA wrapper, as ``tests/test_flash_kernel.py``
runs it) on the same numpy inputs: the JAX test's grid (S 64 and 128,
(bq, bk) (16, 16) and (32, 64), GQA 1 and 2, f32 and bf16), causal and
full; MQA (Hkv 1) at hd 16 and 64; a GQA case whose kv heads differ, so a
kv-head mapping of h % Hkv instead of h // (Hq / Hkv) fails; and the
port's own ``chunked_attention``.

Tolerances: f32 at 2e-5 (both sides sum in f32, in another order), bf16
at 2e-2 (the same bf16 inputs on both sides; the output rounds to bf16,
one ulp being 2^-8 relative), as in ``tests/test_flash_kernel.py``.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against the plain version there. Here the wrapper's argument checks, and
the check that ``chip_smoke.py`` holds bf16 outputs to, are tested."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.attention import chunked_attention

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(b, s, hq, hkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, h, hd)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    jax_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("s,bq,bk", [(64, 16, 16), (128, 32, 64)])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(s, bq, bk, gqa, dtype, causal):
    b, hq, hd = 2, 4, 16
    (qj, kj, vj), (q, k, v) = _inputs(b, s, hq, hq // gqa, hd, dtype)
    want = jflash(qj, kj, vj, causal=causal, bq=bq, bk=bk, interpret=True)
    got = tfa.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_mqa_matches_pallas(hd, causal):
    (qj, kj, vj), (q, k, v) = _inputs(2, 64, 4, 1, hd, "float32", seed=1)
    want = jflash(qj, kj, vj, causal=causal, bq=32, bk=16, interpret=True)
    got = tfa.flash_attention(q, k, v, causal=causal, bq=32, bk=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])


def test_query_head_reads_kv_head_h_div_g():
    """Hq 4 over Hkv 2: heads 0, 1 read kv head 0 and heads 2, 3 kv head 1
    (``jnp.repeat``), not h % Hkv. The kv heads are far apart, so the
    other mapping misses by far more than the tolerance."""
    b, s, hq, hkv, hd = 1, 32, 4, 2, 16
    (qj, kj, vj), (q, k, v) = _inputs(b, s, hq, hkv, hd, "float32", seed=2)
    v = v + torch.tensor([0.0, 10.0])[None, None, :, None]
    vj = jnp.asarray(v.numpy())
    got = tfa.flash_attention(q, k, v, bq=16, bk=16)
    want = jflash(qj, kj, vj, bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])
    g = hq // hkv
    for heads, what in (([h // g for h in range(hq)], True),
                        ([h % hkv for h in range(hq)], False)):
        kr, vr = k[:, :, heads], v[:, :, heads]
        ref = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, kr) * hd ** -0.5
                            + torch.triu(torch.full((s, s), -torch.inf), 1),
                            -1)
        ref = torch.einsum("bhqk,bkhd->bqhd", ref, vr)
        assert torch.allclose(got, ref, rtol=2e-5, atol=2e-5) is what


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_chunked_attention(causal, dtype):
    """The port's flash and its training attention are one function."""
    _, (q, k, v) = _inputs(2, 128, 8, 2, 32, dtype, seed=3)
    got = tfa.flash_attention(q, k, v, causal=causal, bq=32, bk=64)
    want = chunked_attention(q, k, v, causal=causal, q_chunk=32, kv_block=32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("wrong", ["p_in_bf16", "late_rows_see_one_key_more"])
def test_chip_check_holds_bf16_to_one_ulp(wrong):
    """chip_smoke.py holds the kernel's bf16 output element by element:
    another f32 computation of the same function (chunked_attention)
    passes, while p rounded to bf16 before PV, or a causal mask that lets
    the second half's rows see one key too many, fails. (p in bf16 passes
    a limit of 2e-2 x max|plain| here, at 0.13 of it.)"""
    cs = _load_chip_smoke()
    _, (q, k, v) = _inputs(1, 256, 4, 2, 32, "bfloat16", seed=5)
    plain = tfa.flash_attention(q, k, v, bq=64, bk=64)
    same = chunked_attention(q, k, v, q_chunk=64, kv_block=32)
    assert cs._flash_err(same, plain, "bfloat16")[1] <= 1.0
    kr, vr = (t.float().repeat_interleave(2, 2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * 32 ** -0.5
    mask = torch.triu(torch.full((256, 256), -torch.inf), 1)
    if wrong == "late_rows_see_one_key_more":
        rows = torch.arange(128, 255)
        mask[rows, rows + 1] = 0.0
    logits = logits + mask
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    pv = p.bfloat16().float() if wrong == "p_in_bf16" else p
    bad = (torch.einsum("bhqk,bkhd->bqhd", pv, vr)
           / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()
    assert cs._flash_err(bad, plain, "bfloat16")[1] > 1.0


def test_default_blocks_cover_short_sequences():
    """bq = bk = 512 against S 96: the blocks shrink to S, as in JAX."""
    (qj, kj, vj), (q, k, v) = _inputs(1, 96, 2, 2, 16, "float32", seed=4)
    want = jflash(qj, kj, vj, interpret=True)
    np.testing.assert_allclose(_np(tfa.flash_attention(q, k, v)),
                               np.asarray(want), **TOL["float32"])


def test_refuses_what_the_tpu_kernel_asserts():
    _, (q, k, v) = _inputs(1, 48, 2, 1, 16, "float32")
    for kw in (dict(bq=32), dict(bk=32), dict(bq=0)):
        with pytest.raises(ValueError, match="not a multiple"):
            tfa.flash_attention(q, k, v, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), k.half(), v.half(), bq=16, bk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q, k.bfloat16(), v, bq=16, bk=16)
    with pytest.raises(ValueError, match="does not fit"):
        tfa.flash_attention(q, k[:, :32], v[:, :32], bq=16, bk=16)
    with pytest.raises(ValueError, match="does not fit"):
        tfa.flash_attention(q[:, :, :1].expand(1, 48, 3, 16).contiguous(),
                            k.expand(1, 48, 2, 16).contiguous(),
                            v.expand(1, 48, 2, 16).contiguous(), bq=16, bk=16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k, v, interpret=True)


def test_kernel_argument_checks():
    """What the CUDA wrapper checks before a launch (on CPU tensors, which
    it would otherwise hand to the plain version)."""
    _, (q, k, v) = _inputs(2, 64, 8, 2, 128, "bfloat16")
    assert tfa._check_cuda_args(q, k, v, 512, 512) == (2, 64, 8, 2, 128)
    for hd in (64, 256):
        _, args = _inputs(1, 32, 4, 1, hd, "float32")
        assert tfa._check_cuda_args(*args, 16, 16)[-1] == hd
    _, small = _inputs(1, 32, 4, 1, 16, "float32")
    with pytest.raises(ValueError, match="head dims"):
        tfa._check_cuda_args(*small, 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_cuda_args(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, 512, 512)
    with pytest.raises(ValueError, match="aligned"):
        tfa._check_cuda_args(torch.zeros(q.numel() + 1, dtype=q.dtype)[1:]
                             .view(q.shape), k, v, 512, 512)
    with pytest.raises(ValueError, match="not a multiple"):
        tfa._check_cuda_args(q, k, v, 48, 512)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# The route table of the CUDA wrapper: the dtype alone picks the route,
# and both routes take every head dim the kernel has an instance for.
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype,route", [("bfloat16", "wgmma"),
                                         ("float32", "simt")])
def test_route_table(hd, dtype, route):
    _, (q, k, v) = _inputs(1, 32, 4, 2, hd, dtype)
    assert tfa._route(q.dtype) == route
    assert tfa._check_cuda_args(q, k, v, 512, 512)[-1] == hd
    assert set(tfa.flash_attention.launches_by_route) == {"simt", "wgmma"}


def _tf32(t):
    """t rounded to TF32 (10 mantissa bits), to nearest."""
    i = t.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _wgmma_model(q, k, v, causal, pv, bn=64):
    """The wgmma route's arithmetic on the CPU: bf16 q k^T products (exact
    in f32) summed in f32 over 64-key tiles, m, l and the rescale of O in
    f32, l summed from the f32 p, and P V taken as ``pv``: "split" (p_hi
    = bf16(p) and p_lo = bf16(p - p_hi), two products), "bf16" (p_hi
    alone), "tf32" or "f32". Returns the output before and after its
    rounding to bf16."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(g, 2).transpose(1, 2)
              for t in (k, v))
    m = torch.full((b, hq, s, 1), tfa.NEG_INF)
    l = torch.zeros((b, hq, s, 1))
    o = torch.zeros((b, hq, s, hd))
    rows = torch.arange(s)[:, None]
    for kv0 in range(0, s, bn):
        kt, vt = kf[:, :, kv0:kv0 + bn], vf[:, :, kv0:kv0 + bn]
        x = (qf @ kt.transpose(-1, -2)) * hd ** -0.5
        if causal:
            keys = torch.arange(kv0, kv0 + kt.shape[2])[None, :]
            x = torch.where(keys <= rows, x, torch.tensor(tfa.NEG_INF))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(x - m_new)
        l, m = l * alpha + p.sum(-1, keepdim=True), m_new
        if pv == "split":
            hi = p.bfloat16().float()
            prod = hi @ vt + (p - hi).bfloat16().float() @ vt
        else:
            pp = {"bf16": lambda: p.bfloat16().float(), "tf32": lambda: _tf32(p),
                  "f32": lambda: p}[pv]()
            prod = pp @ vt
        o = o * alpha + prod
    out = (o / l.clamp(min=1e-30)).transpose(1, 2)
    return out, out.bfloat16()


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_split_pv_keeps_the_one_ulp_contract(hd, causal):
    """The rounding of the wgmma route, modelled in f32 on the CPU, meets
    the check chip_smoke.py holds the kernel to (one output ulp, element
    by element), while P V with p in bf16 alone fails it at every head
    dim. TF32 (which wgmma takes K-major only) fails it in causal
    attention, whose first rows put most of their weight on a few keys;
    in full attention it lands near the limit (0.94-1.5 x at these and
    nearby sizes), so there its error before the output rounding is held
    instead: about 2^-13 of max|out| where the split's is about 2^-19."""
    cs = _load_chip_smoke()
    hq, hkv = (2, 1) if hd == 256 else (4, 2)
    _, (q, k, v) = _inputs(1, 256, hq, hkv, hd, "bfloat16", seed=0)
    plain = tfa.flash_attention_plain(q, k, v, causal=causal)
    ratio = {pv: cs._flash_err(_wgmma_model(q, k, v, causal, pv)[1], plain,
                               "bfloat16")[1]
             for pv in ("split", "bf16", "tf32")}
    assert ratio["split"] <= 1.0
    assert ratio["bf16"] > 4.0
    if causal:
        assert ratio["tf32"] > 1.0
    exact = _wgmma_model(q, k, v, causal, "f32")[0]
    scale = exact.abs().max()
    drift = {pv: ((_wgmma_model(q, k, v, causal, pv)[0] - exact).abs().max()
                  / scale).item() for pv in ("split", "tf32")}
    assert drift["split"] < 2.0 ** -17
    assert drift["tf32"] > 2.0 ** -14 > 8 * drift["split"]


def test_p_in_bf16_negative_control_fails_the_check():
    """chip_smoke.py's negative control of the split P V (the plain output
    with p rounded to bf16 before P V) fails the one-ulp check at a small
    GQA causal shape, where the plain version passes it."""
    cs = _load_chip_smoke()
    _, (q, k, v) = _inputs(1, 256, 8, 2, 128, "bfloat16", seed=6)
    plain = tfa.flash_attention_plain(q, k, v)
    assert cs._flash_err(plain, plain, "bfloat16")[1] == 0.0
    wrong = cs._flash_p_bf16(torch, q, k, v, True)
    assert wrong.shape == q.shape and wrong.dtype == q.dtype
    assert cs._flash_err(wrong, plain, "bfloat16")[1] > 1.0
    full = cs._flash_p_bf16(torch, q, k, v, False)
    assert cs._flash_err(full, tfa.flash_attention_plain(q, k, v,
                                                         causal=False),
                         "bfloat16")[1] > 1.0
