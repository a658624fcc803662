"""The split-and-merge of the paged attention kernel, modelled in torch.

``csrc/paged_attention.cu`` splits the pages of a slot across CTAs
(``paged_attention.pages_per_split``, from the table width alone); in a
CTA each warp owns 4 tokens of every page with its own online-softmax
state, the warps merge in order, and the splits' partial (m, l, acc)
merge in split order. ``split_model`` below computes exactly that order
of operations in f32 on the CPU, and is held here against the port's
``paged_attention_ref`` and the JAX ``paged_attention_pallas`` in
interpret mode: ragged lengths with an empty slot (exact zeros), splits
wholly past the length and windows that leave whole splits behind (both
must report l = 0), a page two slots share, the tanh softcap, and int8
pools with per-row scales.

Tolerances: as ``tests/test_torch_paged_attention.py``: f32 at atol 1e-5
(summation order only), bf16 at atol 2e-2 (the reference rounds p to bf16
before P V; the kernel and the model keep it f32)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.quant.core import quantize_rows

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEG_INF = tpa.NEG_INF
TPW = 4                                  # tokens of a page a warp owns


def split_model(q, k_pool, v_pool, page_table, lengths, *, k_scale=None,
                v_scale=None, window=None, softcap=0.0):
    """The kernel's order of operations, in f32: returns (out in q's
    dtype, l of every split (B, Hkv, splits, G))."""
    b, _, hq, hd = q.shape
    _, page, hkv, _ = k_pool.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    pps, ns = tpa.pages_per_split(maxp), tpa.num_splits(maxp)
    scale = hd ** -0.5
    out = torch.zeros((b, hkv, g, hd))
    split_l = torch.zeros((b, hkv, ns, g))
    for bi in range(b):
        n = int(lengths[bi])
        lo = max(n - window, 0) if window else 0
        j_lo, j_hi = lo // page, min(-(-n // page), maxp)
        for h in range(hkv):
            qg = q[bi, 0, h * g:(h + 1) * g].float()
            parts = []
            for s in range(ns):
                j0, j1 = max(s * pps, j_lo), min((s + 1) * pps, j_hi)
                warps = []
                for w in range(page // TPW):
                    m = torch.full((g,), NEG_INF)
                    l, acc = torch.zeros(g), torch.zeros((g, hd))
                    for j in range(j0, j1):
                        t = torch.arange(TPW * w, TPW * (w + 1))
                        kpos = j * page + t
                        valid = (kpos < n) & (kpos >= lo)
                        phys = int(page_table[bi, j])
                        # rows the kernel does not read are zero-filled
                        k = torch.where(valid[:, None],
                                        k_pool[phys, t, h].float(), 0.0)
                        v = torch.where(valid[:, None],
                                        v_pool[phys, t, h].float(), 0.0)
                        logit = qg @ k.T
                        if k_scale is not None:
                            logit = logit * k_scale[phys, t, h]
                            v = v * v_scale[phys, t, h][:, None]
                        logit = logit * scale
                        if softcap:
                            logit = torch.tanh(logit / softcap) * softcap
                        mx = torch.where(valid, logit, NEG_INF).amax(1)
                        m_new = torch.maximum(m, mx)
                        alpha = torch.exp(m - m_new)
                        p = torch.where(valid, torch.exp(logit - m_new[:, None]),
                                        0.0)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ v
                        m = m_new
                    warps.append((m, l, acc))
                mw = torch.stack([st[0] for st in warps]).amax(0)
                f = [torch.exp(st[0] - mw) for st in warps]
                acc = sum(fi[:, None] * st[2] for fi, st in zip(f, warps))
                lw = sum(fi * st[1] for fi, st in zip(f, warps))
                if j1 <= j0:
                    lw = torch.zeros(g)
                split_l[bi, h, s] = lw
                parts.append((mw, lw, acc))
            live = [st for st in parts if bool((st[1] > 0).all())]
            if not live:
                continue                   # out stays exactly 0
            mg = torch.stack([st[0] for st in live]).amax(0)
            acc = torch.zeros((g, hd))
            lg = torch.zeros(g)
            for m_s, l_s, a_s in live:     # split order
                f = torch.exp(m_s - mg)
                acc = acc + f[:, None] * a_s
                lg = lg + f * l_s
            out[bi, h] = acc / torch.clamp(lg, min=1e-30)[:, None]
    return out.reshape(b, 1, hq, hd).to(q.dtype), split_l


# (b, hq, hkv, hd, page, maxp, lengths): several splits a slot, slot 0
# empty, slot 1 full, a last split of one page
CASES = [
    (4, 4, 2, 16, 8, 13, (0, 104, 37, 61)),
    (3, 8, 1, 16, 4, 9, (0, 36, 13)),
    (4, 4, 4, 32, 16, 10, (0, 160, 70, 1)),
]


def _case(case, seed=0):
    b, hq, hkv, hd, page, maxp, lengths = case
    rng = np.random.default_rng(seed)
    npages = 1 + b * maxp
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    kp = rng.normal(size=(npages, page, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(npages, page, hkv, hd)).astype(np.float32)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp).astype(np.int32)
    table[2, 0] = table[1, 0]               # a page two slots share
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (19, 0.0),
                                            (40, 5.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_matches_ref_and_pallas(case, window, softcap, dtype):
    q, kp, vp, table, lengths = _case(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(table), jnp.asarray(lengths))
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
             torch.from_numpy(lengths))
    got, split_l = split_model(*targs, window=window, softcap=softcap)
    assert got.dtype == tdt and got.shape == q.shape
    assert (got[0] == 0).all(), "an empty slot must give exact zeros"
    got = got.float().numpy()
    pallas = jpa.paged_attention_pallas(*jargs, window=window,
                                        softcap=softcap, interpret=True)
    ref = tpa.paged_attention_ref(*targs, window=window, softcap=softcap)
    for want in (np.asarray(pallas.astype(jnp.float32)), ref.float().numpy()):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    _check_split_l(case, split_l, window)


def _check_split_l(case, split_l, window):
    """l = 0 exactly where a split has no live page (past the length, or
    wholly behind the window), l > 0 elsewhere."""
    _, _, _, _, page, maxp, lengths = case
    pps = tpa.pages_per_split(maxp)
    for bi, n in enumerate(lengths):
        lo = max(n - window, 0) if window else 0
        for s in range(tpa.num_splits(maxp)):
            first, last = s * pps * page, min((s + 1) * pps, maxp) * page
            live = first < n and last > lo
            assert bool((split_l[bi, :, s] > 0).all()) == live
            assert live or bool((split_l[bi, :, s] == 0).all())


def test_a_window_leaves_whole_splits_behind():
    """Slot 1 (104 tokens in 13 8-token pages: splits of 4, 4, 4 and 1
    pages) with a window of 8: every split but the last lies behind it
    and reports l = 0, and the output is still the reference's."""
    case = CASES[0]
    args = [torch.from_numpy(a) for a in _case(case)]
    got, split_l = split_model(*args, window=8)
    np.testing.assert_allclose(
        got.numpy(), tpa.paged_attention_ref(*args, window=8).numpy(),
        rtol=0, atol=TOL["float32"])
    assert bool((split_l[1, :, :3] == 0).all())
    assert bool((split_l[1, :, 3] > 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_model_int8_pools(dtype):
    """int8 pools: K's row scale after the dot product, V's on the row."""
    q, kp, vp, table, lengths = _case(CASES[0], seed=3)
    tdt = getattr(torch, dtype)
    kq, ks = quantize_rows(torch.from_numpy(kp))
    vq, vs = quantize_rows(torch.from_numpy(vp))
    args = (torch.from_numpy(q).to(tdt), kq, vq, torch.from_numpy(table),
            torch.from_numpy(lengths))
    for window, softcap in ((None, 0.0), (19, 5.0)):
        kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=softcap)
        got, split_l = split_model(*args, **kw)
        assert (got[0] == 0).all()
        want = tpa.paged_attention_ref(*args, **kw)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0, atol=TOL[dtype])
        _check_split_l(CASES[0], split_l, window)


@pytest.mark.parametrize("maxp,pps,splits", [
    (1, 4, 1), (2, 4, 1), (16, 4, 4), (13, 4, 4), (256, 4, 64),
    (257, 5, 52), (2048, 32, 64), (1 << 16, 1024, 64)])
def test_split_plan(maxp, pps, splits):
    """The split size comes from maxp alone: one split at the serve path's
    2-page tables, 32 pages a split at a 32,768-token context in 16-token
    pages, never more than MAX_SPLITS splits, and every page in a split."""
    assert tpa.pages_per_split(maxp) == pps
    assert tpa.num_splits(maxp) == splits <= tpa.MAX_SPLITS
    assert (splits - 1) * pps < maxp <= splits * pps


def test_kernel_takes_the_configs_shapes_and_refuses_others():
    """hd 64, 128, 256 (and the smoke configs' 16), G 1 to 16, pages of 8
    and 16 pass the CUDA wrapper's checks; what the kernel cannot take
    raises before a launch."""
    def args(b=2, hq=8, hkv=2, hd=128, page=16, maxp=4, npages=9):
        return (torch.zeros((b, 1, hq, hd)), torch.zeros((npages, page, hkv, hd)),
                torch.zeros((npages, page, hkv, hd)),
                torch.zeros((b, maxp), dtype=torch.int32),
                torch.zeros(b, dtype=torch.int32))
    for kw in (dict(hd=64, hq=32, hkv=32), dict(hd=256, hq=4, hkv=2),
               dict(hd=128, hq=16, hkv=1), dict(page=8), dict(hd=16)):
        tpa._check_cuda_args(*args(**kw))
    for kw in (dict(hd=24), dict(hd=272), dict(hq=32, hkv=1), dict(page=6),
               dict(page=64)):
        with pytest.raises(ValueError, match="paged_attention's kernel"):
            tpa._check_cuda_args(*args(**kw))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_long_context_negative_control_fails_the_slot_check():
    """chip_smoke.py's negative control of the split merge, at a small
    size: the plain output with the longest slot's last split of pages
    left out must fail the per-slot ATTN_TOL check that the kernel's
    output passes (here: the model's)."""
    cs = _load_chip_smoke()
    case = (4, 8, 2, 16, 16, 64, (0, 1, 300, 1024))
    q, kp, vp, table, lengths = (torch.from_numpy(a).to(torch.bfloat16)
                                 if a.dtype == np.float32
                                 else torch.from_numpy(a)
                                 for a in _case(case, seed=5))
    args = (q, kp, vp, table, lengths)
    plain = tpa.paged_attention_ref(*args)
    model, _ = split_model(*args)
    cs._check_slots("model", model, plain, cs.ATTN_TOL["bfloat16"])
    cut = cs._last_split_left_out(lengths, table.shape[1], kp.shape[1])
    wrong = tpa.paged_attention_ref(q, kp, vp, table, cut)
    with pytest.raises(AssertionError):
        cs._check_slots("cut", wrong, plain, cs.ATTN_TOL["bfloat16"])
