"""The 3xTF32 products of ``esffn_mlp``'s kernel, modelled in torch.

``csrc/mma_sync.cuh`` splits each f32 operand x as hi = tf32(x) (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and lo = x - hi,
which the tensor core reads truncated to TF32 (its top 19 bits), and
sums lo*hi + hi*lo + hi*hi in f32. Here both roundings are emulated by
bit masking, the products are f32 matmuls of the rounded operands (a
product of two TF32 values is exact in f32), and the
model of the whole 2-MLP forward at Swin-MoE-Small's stage-2 widths (D
384, F 1536, blocks of 128 rows) is held against the port's f32 plain
version (``esffn_mlp_plain``, itself held to the JAX kernel in
``tests/test_torch_esffn_mlp.py``) within ``chip_smoke.SWIN_KERNEL_TOL``,
the limit the card's kernel meets. One TF32 pass is measured the same way
and reported beside it."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.core.reindex import build_reindex, gather_rows
from repro_torch.kernels import esffn

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
