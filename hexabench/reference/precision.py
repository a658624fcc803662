"""Matrix products of the references at a stated precision.

"f32" is the reference itself (TF32 off). The controls take the nearest
precision below the configuration's: "tf32" rounds every operand of every
product, forward and backward, to TF32's 10-bit mantissa (as a TF32
tensor-core product reads them), and keeps f32 storage; "fp8" rounds both
operands of a product to e4m3, with one absmax scale a weight matrix and
a row of activations, and keeps f32 between the products: the mildest
fp8 path, e4m3 products over wider activations. Rounding is explicit, so
a control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with its mantissa rounded to 10 bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under an absmax scale (over ``dim``, or the
    whole tensor)."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    s = torch.clamp(amax, min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).transpose(-1, -2)
        if b.ndim == 2:
            k, m = b.shape
            gb = round_tf32(a).reshape(-1, k).t() @ g.reshape(-1, m)
        else:
            gb = round_tf32(a).transpose(-1, -2) @ g
        return ga, gb


def matmul(precision: str):
    """``a @ b`` at ``precision``; ``b`` is a weight (2-d) or has ``a``'s
    batch dims."""
    if precision == "f32":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    if precision == "fp8":
        return lambda a, b: (round_fp8(a, dim=-1) @ round_fp8(b)
                             if b.ndim == 2 else
                             round_fp8(a, dim=-1) @ round_fp8(b, dim=-2))
    raise ValueError(f"unknown precision {precision!r}")
