"""The 3xTF32 products of the kernels on ``csrc/mma_sync.cuh``, modelled in
torch: ``esffn_mlp``'s, ``esmm``'s ``mma_tf32x3`` route and ``esfk``'s.

The mainloop splits each f32 operand x as hi = tf32(x) (round to nearest,
ties away from zero, as ``cvt.rna.tf32.f32``) and lo = x - hi, which the
tensor core reads truncated to TF32 (its top 19 bits), and sums lo*hi +
hi*lo + hi*hi in f32. Here both roundings are emulated by bit masking,
and the products are f32 matmuls of the rounded operands (a product of
two TF32 values is exact in f32).

* ``esffn_mlp``: the model of the whole 2-MLP forward at Swin-MoE-Small's
  stage-2 widths (D 384, F 1536, blocks of 128 rows) is held against the
  port's f32 plain version (``esffn_mlp_plain``, itself held to the JAX
  kernel in ``tests/test_torch_esffn_mlp.py``) within
  ``chip_smoke.SWIN_KERNEL_TOL``, the limit the card's kernel meets. One
  TF32 pass is measured the same way and reported beside it.
* ``esmm`` and ``esfk`` also promote: each 8-deep k step's products go
  into a fresh register tile and are added into the f32 accumulator by
  a rounded f32 add (``mm_promoted``). Their models are held to their
  plain versions (themselves held to the Pallas kernels in interpret mode
  by ``tests/test_torch_esmm_estmm.py`` and ``tests/test_torch_esfk_ess.py``)
  within ``GEMM_TOL["float32"]`` and ``SWIN_KERNEL_TOL``: ``esmm`` in both
  weight orientations at the Swin stage-2 and the LM expert widths;
  ``esfk`` with its row split, its fixed-order merge and its db summation
  order, and its no-db form, ``estmm``'s f32 route. With bf16 xs (8-bit weights), lo(x) = 0 and the route takes two
  products, not three: the same bits. The Fig. 12 ablation of
  ``chip_smoke.py`` phase 11 runs both dW on the same kernel; the gap
  between ``esfk`` in 3xTF32 and ``estmm``'s f32 FMA (its simt route) is
  predicted as a share of ``SWIN_ABLATION_TOL``. What the
  models leave out: the tensor core's own rounding inside one k step's
  products, which the promotion keeps to one step's partial sum."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.core.reindex import build_reindex, gather_rows
from repro_torch.kernels import esffn, esfk, esmm, estmm
from repro_torch.quant.core import dequantize_blockwise, quantize_blockwise

torch.set_num_threads(1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads an f32 register as TF32: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a, b):
    """The kernel's product: hi rounded to nearest, lo = x - hi truncated."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32x3_rna(a, b):
    """Both parts rounded to nearest (two cvt.rna.tf32.f32 a value)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def mlp_model(mm, x, row_token, row_gate, block_expert, w1, b1, w2, b2,
              act="gelu"):
    """The f32 2-MLP forward with its two products taken by ``mm``: z =
    x W1 + b1, h = act(z), acc = b2 + h W2, out = acc * gate."""
    nblk = block_expert.shape[0]
    blk = row_token.shape[0] // nblk
    xb = gather_rows(x, row_token).reshape(nblk, blk, -1)
    out = []
    for i, e in enumerate(block_expert.tolist()):
        h = ACTIVATIONS[act](mm(xb[i], w1[e]) + b1[e])
        out.append((b2[e] + mm(h, w2[e]))
                   * row_gate.reshape(nblk, blk, 1)[i])
    return torch.cat(out)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _stage2(seed=0, n=384, d=384, f=1536, e=2):
    """chip_smoke.py phase 9's operands at stage-2 widths, a few blocks:
    x ~ N(0, 1), W ~ 0.02 N(0, 1), biases ~ 0.1 N(0, 1), top-1 routing."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    idx = torch.randint(0, e, (n, 1), generator=g, dtype=torch.int32)
    gates = torch.rand((n, 1), generator=g) + 0.5
    ri = build_reindex(idx, gates, e, 128)
    w1 = torch.randn((e, d, f), generator=g) * 0.02
    w2 = torch.randn((e, f, d), generator=g) * 0.02
    b1 = torch.randn((e, f), generator=g) * 0.1
    b2 = torch.randn((e, d), generator=g) * 0.1
    return (x, ri.row_token, ri.row_gate, ri.block_expert, w1, b1, w2, b2)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -1.0 - 2 ** -10, 1.0 + 2 ** -10, 3.0e-39])
    got = tf32(x)
    np.testing.assert_array_equal(got[:5].numpy(), want[:5].numpy())
    # a denormal keeps its top 10 mantissa bits
    assert got[5].item() == pytest.approx(3.0e-39, rel=2 ** -9)
    # hi + lo carries x to within 2^-21 of it
    v = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    hi = tf32(v)
    lo = tf32(v - hi)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -21).all()


def test_tf32x3_stays_inside_the_swin_kernel_limit():
    """3xTF32 at stage-2 widths lands well inside SWIN_KERNEL_TOL (1e-4 x
    max|plain|; 0.007-0.011 of it over five seeds on the CPU); one TF32
    pass does not (3.3-4.1 x the limit over the same seeds)."""
    cs = _load_chip_smoke()
    args = _stage2()
    plain = esffn.esffn_mlp_plain(*args)
    limit = cs.SWIN_KERNEL_TOL * plain.abs().max().item()
    err3 = (mlp_model(mm_tf32x3, *args) - plain).abs().max().item()
    err3r = (mlp_model(mm_tf32x3_rna, *args) - plain).abs().max().item()
    err1 = (mlp_model(mm_tf32, *args) - plain).abs().max().item()
    print(f"3xTF32 at {err3 / limit:.3g} x SWIN_KERNEL_TOL (both parts "
          f"rounded: {err3r / limit:.3g} x), one TF32 pass at "
          f"{err1 / limit:.3g} x")
    assert err3 <= 0.05 * limit and err3r <= 0.05 * limit
    assert err1 > limit


# ---- esmm (mma_tf32x3) and esfk: 3xTF32 with promotion ---------------------

def mm_promoted(a, b, acc=None, exact_a=False):
    """acc + a @ b as the promoting mainloop sums it: per 8-deep k step,
    lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) summed in f32 (lo(a) hi(b)
    skipped when a is exact in TF32), then added to acc in f32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    if acc is None:
        acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        step = ah[:, ks] @ bl[ks]
        if not exact_a:
            step = al[:, ks] @ bh[ks] + step
        acc = acc + (step + ah[:, ks] @ bh[ks])
    return acc


def esmm_model(xs, w, b, block_expert, transpose_rhs=False, exact_a=False):
    """esmm's mma_tf32x3 route, block by block: f32 products of xs (as f32)
    and W from the f32 bias, rounded once to xs.dtype."""
    nblk = block_expert.shape[0]
    blk = xs.shape[0] // nblk
    out = []
    for i, e in enumerate(block_expert.tolist()):
        we = w[e].float()
        we = we.t() if transpose_rhs else we
        acc = torch.zeros((blk, we.shape[1])) if b is None \
            else b[e].float().expand(blk, -1)
        out.append(mm_promoted(xs[i * blk:(i + 1) * blk].float(), we, acc,
                               exact_a))
    return torch.cat(out).to(xs.dtype)


def _blocks(nblk_per_expert, e, seed):
    """A sorted layout of 128-row blocks: expert i owns
    nblk_per_expert[i] consecutive blocks (0: an empty expert)."""
    be = torch.tensor([i for i in range(e) for _ in range(nblk_per_expert[i])],
                      dtype=torch.int32)
    counts = torch.tensor([128 * c for c in nblk_per_expert], dtype=torch.int32)
    return be, counts, torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("k,n", [(384, 1536), (1536, 384), (2048, 768),
                                 (768, 2048)])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_esmm_tf32x3_within_the_f32_gemm_limit(k, n, transpose_rhs):
    """esmm's f32 products in 3xTF32 with promotion, at the Swin stage-2
    (z and t at K 384, dX at K 1536) and the LM expert widths (K 2048 and
    768), with a bias: within GEMM_TOL["float32"] of esmm_plain, at
    0.07-0.10 of it on the CPU, where the plain version's own f32 sum is
    the larger part of the gap (3 x the model's error against f64)."""
    cs = _load_chip_smoke()
    be, _, g = _blocks([1, 1], 2, seed=3)
    xs = torch.randn((256, k), generator=g)
    w = torch.randn((2, n, k) if transpose_rhs else (2, k, n), generator=g) \
        * 0.02
    b = torch.randn((2, n), generator=g) * 0.1
    plain = esmm.esmm_plain(xs, w, b, be, transpose_rhs=transpose_rhs)
    model = esmm_model(xs, w, b, be, transpose_rhs)
    ratio = (model - plain).abs().max().item() / (
        cs.GEMM_TOL["float32"] * plain.abs().max().item())
    print(f"esmm 3xTF32 K {k} N {n} transposed={transpose_rhs}: "
          f"{ratio:.3g} x GEMM_TOL")
    assert ratio <= 0.25


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_esmm_8bit_bf16_xs_two_products_equal_three(mode, transpose_rhs):
    """With bf16 xs and a dequantized 8-bit W, hi(x) = x and lo(x) = 0, so
    the route's two products give the three-product sum bit for bit; both
    lie within GEMM_TOL["bfloat16"] of esmm_plain, and the f32-xs form
    within GEMM_TOL["float32"]."""
    cs = _load_chip_smoke()
    be, _, g = _blocks([1, 1], 2, seed=4)
    k, n = 256, 384
    xs = torch.randn((256, k), generator=g).bfloat16()
    w = torch.randn((2, n, k) if transpose_rhs else (2, k, n), generator=g) \
        * 0.02
    q, sc = quantize_blockwise(w, mode=mode)
    xf = xs.float()
    assert torch.equal(tf32(xf), xf) and not (xf - tf32(xf)).any()
    wdq = dequantize_blockwise(q, sc)
    kw = dict(transpose_rhs=transpose_rhs)
    two = esmm_model(xs, wdq, None, be, exact_a=True, **kw)
    three = esmm_model(xs, wdq, None, be, exact_a=False, **kw)
    assert torch.equal(two, three)
    plain = esmm.esmm_plain(xs, q, None, be, w_scales=sc, **kw)
    for got, x, tol in ((two, xs, cs.GEMM_TOL["bfloat16"]),
                        (esmm_model(xf, wdq, None, be, **kw),
                         xf, cs.GEMM_TOL["float32"])):
        want = esmm.esmm_plain(x, q, None, be, w_scales=sc, **kw)
        assert (got.float() - want.float()).abs().max() <= \
            tol * want.float().abs().max()
    assert two.dtype == plain.dtype == torch.bfloat16


def esfk_model(x1, x2, counts, splits, bk=32, with_db=True):
    """esfk's tensor-core kernel: each expert's run of rows (the tail past
    the counts to the last expert) cut into ``splits`` runs of whole
    32-row slices; each run's dW by promoted 3xTF32 steps from 0, its db
    as two row lanes (rows 0-15 and 16-31 of every slice, each summed in
    row order) added in order; then the runs summed in run order. An
    expert with no rows gets exact zeros. ``with_db=False`` is estmm's
    mma_tf32x3 route, the same kernel without db: dW alone."""
    np_rows, e = x1.shape[0], counts.shape[0]
    dw = torch.zeros((e, x1.shape[1], x2.shape[1]))
    db = torch.zeros((e, x2.shape[1]))
    starts = torch.cumsum(counts, 0) - counts
    for i in range(e):
        lo = int(starts[i])
        if int(counts[i]) == 0:
            continue
        hi = np_rows if i == e - 1 else lo + int(counts[i])
        chunk = -(-(-(-(hi - lo) // splits)) // bk) * bk
        parts_w, parts_b = [], []
        for sp in range(splits):
            r0, r1 = min(hi, lo + sp * chunk), min(hi, lo + (sp + 1) * chunk)
            parts_w.append(mm_promoted(x1[r0:r1].t(), x2[r0:r1]))
            lanes = [torch.zeros(x2.shape[1]) for _ in range(2)]
            for r in range(r0, r1):
                h = (r - r0) % bk // (bk // 2)
                lanes[h] = lanes[h] + x2[r]
            parts_b.append(lanes[0] + lanes[1])
        dw[i], db[i] = parts_w[0], parts_b[0]
        for pw, pb in zip(parts_w[1:], parts_b[1:]):
            dw[i], db[i] = dw[i] + pw, db[i] + pb
    return (dw, db) if with_db else dw


@pytest.mark.parametrize("splits", [1, 3])
def test_esfk_tf32x3_within_the_swin_kernel_limit(splits):
    """esfk's model at the stage-2 widths (dW1: D1 384, D2 1536) over
    three experts, one of them empty, one with the tail rows: dW and db
    within SWIN_KERNEL_TOL of esfk_plain, the empty expert exactly 0, and
    splitting the rows moves dW by no more than the limit either."""
    cs = _load_chip_smoke()
    be, counts, g = _blocks([2, 0, 3], 3, seed=5)
    counts[-1] -= 128                     # the last block is the tail
    x1 = torch.randn((640, 384), generator=g)
    x2 = torch.randn((640, 1536), generator=g)
    pw, pb = esfk.esfk_plain(x1, x2, be, counts)
    mw, mb = esfk_model(x1, x2, counts, splits)
    for got, want in ((mw, pw), (mb, pb)):
        ratio = (got - want).abs().max().item() / (
            cs.SWIN_KERNEL_TOL * want.abs().max().item())
        print(f"esfk splits {splits}: {ratio:.3g} x SWIN_KERNEL_TOL")
        assert ratio <= 0.05
    assert not mw[1].any() and not mb[1].any()


@pytest.mark.parametrize("splits", [1, 3])
def test_estmm_tf32x3_no_db_within_the_f32_gemm_limit(splits):
    """estmm's mma_tf32x3 route (esfk's kernel without db) at a small
    ragged layout: blk 8, runs of 24, 0 and 40 rows plus a tail block of
    the last expert, D1 12 and D2 20 (three whole 16-byte copies and a
    partial tile): within GEMM_TOL["float32"] of estmm_plain, the empty
    expert exactly 0, and dW the same bits as esfk's."""
    cs = _load_chip_smoke()
    be = torch.tensor([0, 0, 0, 2, 2, 2, 2, 2, 2], dtype=torch.int32)
    counts = torch.tensor([24, 0, 40], dtype=torch.int32)
    g = torch.Generator().manual_seed(8)
    x1 = torch.randn((72, 12), generator=g)
    x2 = torch.randn((72, 20), generator=g)
    assert estmm._route(torch.float32, 8, 12, 20) == "mma_tf32x3"
    want = estmm.estmm_plain(x1, x2, be, counts)
    got = esfk_model(x1, x2, counts, splits, with_db=False)
    ratio = (got - want).abs().max().item() / (
        cs.GEMM_TOL["float32"] * want.abs().max().item())
    print(f"estmm 3xTF32 splits {splits}: {ratio:.3g} x GEMM_TOL")
    assert ratio <= 0.25
    assert not got[1].any()
    assert torch.equal(got, esfk_model(x1, x2, counts, splits)[0])


def estmm_simt_model(x1, x2):
    """estmm's f32 simt kernel for one expert: each output summed over the
    rows in row order, in f32 (a multiply and an add rounded apart here,
    where the card fuses them)."""
    acc = torch.zeros((x1.shape[1], x2.shape[1]))
    for r in range(x1.shape[0]):
        acc = acc + torch.outer(x1[r], x2[r])
    return acc


def test_esfk_fused_vs_unfused_gap_is_inside_the_ablation_limit():
    """The prediction for phase 11's ablation, over one expert of 3,264
    rows (the stage-2 mean) at D1 384, 6 splits as at stage 2: the
    unfused backward's dW (estmm's mma_tf32x3 route, esfk's kernel without
    db at the same splits) is the fused one's (esfk) bit for bit, so on
    the card only db's summation order (ESS against esfk's row lanes) and
    the grads' atomic adds are left to move the grads. Rows that are not
    whole 16-byte copies would take estmm's f32 simt sum in row order: that
    gap, as a share of SWIN_ABLATION_TOL x max|dW|, is 0.24 on the CPU,
    almost all of it the row-order f32 sum's own error (3xTF32 against
    f64: 0.02)."""
    cs = _load_chip_smoke()
    be, counts, g = _blocks([26], 1, seed=6)
    counts[0] = 3264
    x1 = torch.randn((3328, 384), generator=g)
    x2 = torch.randn((3328, 384), generator=g)
    x1[3264:] = 0.0
    fused = esfk_model(x1, x2, counts, splits=6)[0][0]
    assert torch.equal(fused, esfk_model(x1, x2, counts, splits=6,
                                         with_db=False)[0])
    unfused = estmm_simt_model(x1[:3264], x2[:3264])
    exact = x1.double().t() @ x2.double()
    lim = cs.SWIN_ABLATION_TOL * unfused.abs().max().item()
    share = (fused - unfused).abs().max().item() / lim
    own = (fused.double() - exact).abs().max().item() / lim
    print(f"fused (3xTF32) vs unfused (row-order f32) dW: {share:.3g} x "
          f"SWIN_ABLATION_TOL; 3xTF32 vs f64: {own:.3g} x")
    assert share <= 0.5 and own <= 0.05


ESMM_Q_ROUTES = [
    # (xs dtype, blk, k, n, route) with an 8-bit W
    (torch.bfloat16, 128, 2048, 768, "mma_tf32x3"),
    (torch.float32, 128, 768, 2048, "mma_tf32x3"),
    (torch.bfloat16, 8, 24, 40, "mma_tf32x3"),
    (torch.bfloat16, 128, 2044, 768, "simt"),
    (torch.float32, 64, 2048, 772, "simt"),
]


@pytest.mark.parametrize("dtype,blk,k,n,route", ESMM_Q_ROUTES)
def test_esmm_8bit_route_rule(dtype, blk, k, n, route):
    """An 8-bit W takes mma_tf32x3 when its rows and xs's are whole 8-byte
    and 16-byte copies (K and N multiples of 8), else simt."""
    assert esmm._route(dtype, blk, k, n, quantized=True) == route


@pytest.mark.parametrize("dtype,d1,d2,route", [
    (torch.float32, 384, 1536, "mma_tf32x3"),
    (torch.float32, 12, 20, "mma_tf32x3"),
    (torch.float32, 384, 1538, None),
    (torch.bfloat16, 2048, 768, "mma_bf16"),
    (torch.bfloat16, 12, 16, None),
])
def test_esfk_route_rule(dtype, d1, d2, route):
    """f32 on mma_tf32x3, bf16 on mma_bf16; rows that are not whole 16-byte
    copies (None) are refused, as no route takes them."""
    be = torch.zeros(2, dtype=torch.int32)
    pc = torch.tensor([256], dtype=torch.int32)
    x1, x2 = (torch.zeros((256, d), dtype=dtype) for d in (d1, d2))
    if route is None:
        with pytest.raises(ValueError, match="16-byte pieces"):
            esfk._check_args(x1, x2, be, pc)
    else:
        assert esfk._route(dtype) == route
        assert esfk._check_args(x1, x2, be, pc)[-1] == route


@pytest.mark.parametrize("np_rows,d1,d2,splits", [
    (26112, 384, 1536, 6), (26112, 1536, 384, 6),   # stage 2: 288 tiles
    (7296, 768, 3072, 1), (7296, 3072, 768, 1),     # stage 3: 1,152 tiles
    (1024, 24, 40, 1),                              # few rows an expert
])
def test_esfk_split_plan(np_rows, d1, d2, splits):
    """Six waves' worth of CTAs on an H100's 132 SMs, at least 512 rows a
    split of an expert's mean run, at least one split."""
    assert esfk._plan(np_rows, d1, d2, 8, 132) == splits


@pytest.mark.parametrize("with_db", [True, False])
def test_split_workspace_holds_the_kernel_layout(with_db):
    """esfk.cu's split partials: (tiles, splits, 128 x 128) f32 of dW,
    then (E, D2 tiles, splits, 128) of db unless the launch is estmm's
    (no db); one ticket a tile; nothing for one split."""
    esfk._WORKSPACE.clear()
    try:
        dev = torch.device("cpu")
        assert esfk._split_workspace(dev, 384, 1536, 8, 1) == (None, None)
        esfk._split_workspace(dev, 384, 1536, 8, 6, with_db=with_db)
        parts, tickets = esfk._WORKSPACE[dev.index]
        tiles = 3 * 12 * 8
        assert tickets.numel() == tiles and not tickets.any()
        assert parts.numel() == tiles * 6 * 128 * 128 + (
            8 * 12 * 6 * 128 if with_db else 0)
    finally:
        esfk._WORKSPACE.clear()


def test_esfk_tensor_core_routes_refuse_misaligned_operands():
    be = torch.zeros(2, dtype=torch.int32)
    pc = torch.tensor([256], dtype=torch.int32)
    x1, x2 = torch.zeros((256, 16)), torch.zeros((256, 24))
    assert esfk._check_args(x1, x2, be, pc) == (256, 16, 24, 1,
                                                  "mma_tf32x3")
    flat = torch.zeros(256 * 16 + 4)
    bad = flat[1:1 + 256 * 16].view(256, 16)
    with pytest.raises(ValueError, match="mma_tf32x3 route.*16-byte"):
        esfk._check_args(bad, x2, be, pc)
    with pytest.raises(ValueError, match="mma_tf32x3 route.*16-byte"):
        esfk._check_args(x1, torch.zeros(256 * 24 + 4)[1:1 + 256 * 24]
                         .view(256, 24), be, pc)
    assert set(esfk.esfk.launches_by_route) == {"mma_tf32x3", "mma_bf16"}
