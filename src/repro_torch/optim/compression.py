"""Error-feedback int8 gradient compression for thin cross-pod links
(counterpart of ``repro.optim.compression``).

The inter-pod hop is the thinnest link of a multi-pod mesh; compressing
the data-parallel gradient reduction over the "pod" axis cuts that
traffic 2x (bf16) or 4x (f32). Error feedback keeps the compression
unbiased over time: the quantisation residual is carried to the next
step (Seide et al.; the 1-bit Adam lineage).

``compressed_psum`` is collective-correct: the shared scale is agreed by
an all-reduce MAX of every rank's ``max|g + residual|`` (over the
``launch.mesh.Mesh`` group of the axis), divided by 127, then the int8
payloads are summed as int32 and dequantised. Integer sums are
associative, so the result is exact for the quantised values: the same
bits as the JAX package's for the same inputs (the scale is one f32
division on every device, ``quant.core._per``). The residual is rounded
once, as XLA's fused multiply-subtract rounds it, so it is JAX's bit for
bit too.

The int8 rounding and clipping convention is ``quant.core``'s
(``quantize_int8``/``dequantize_int8``), the one the expert weights use.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.common import tree_map
from repro_torch.quant.core import _per, dequantize_int8, quantize_int8


def _residual(gf: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``gf - q * scale`` rounded once, as the fused multiply-subtract
    XLA emits for it: the product of an int8 and an f32 and its
    difference from a close f32 are exact in f64."""
    return (gf.double() - q.double() * scale.double()).float()


def compress_roundtrip(x: torch.Tensor) -> tuple:
    """(reconstruction, residual) of one tensor (local use and tests)."""
    scale = _per(torch.max(torch.abs(x)).float(), 127.0)
    q = quantize_int8(x, scale)
    rec = dequantize_int8(q, scale).to(x.dtype)
    return rec, x - rec


def compressed_psum(g: torch.Tensor, mesh, axis,
                    residual: Optional[torch.Tensor] = None) -> tuple:
    """Sum of ``g`` over the ``mesh`` group of ``axis`` with an int8
    payload and error feedback. Returns (summed gradient, new residual),
    both in ``g``'s dtype; every rank of the group gets the same sum."""
    gf = g.float()
    if residual is not None:
        gf = gf + residual.float()
    amax = torch.max(torch.abs(gf)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    scale = _per(amax[0], 127.0)
    q = quantize_int8(gf, scale)
    new_residual = _residual(gf, q, scale)
    total = mesh.all_reduce(q.to(torch.int32), axis)
    out = dequantize_int8(total, scale).to(g.dtype)
    return out, new_residual.to(g.dtype)


def tree_compressed_psum(grads: Any, mesh, axis,
                         residuals: Optional[Any] = None) -> tuple:
    """``compressed_psum`` of every leaf of a tree of dicts and lists;
    ``residuals`` None starts from zeros. Returns (sums, residuals), two
    trees of ``grads``' structure."""
    if residuals is None:
        residuals = tree_map(torch.zeros_like, grads)
    pairs = tree_map(lambda g, r: compressed_psum(g, mesh, axis, r), grads,
                     residuals)
    return (tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs))
