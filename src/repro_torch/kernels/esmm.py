"""ESMM — expert-specific matrix multiplication over the expert-sorted
layout (paper Fig. 4(b); counterpart of ``repro.kernels.esmm.esmm_pallas``).

``ys[i] = xs[i] @ W[e(i)] (+ b[e(i)])`` where every BLK-row block of ``xs``
belongs to the one expert ``block_expert[block]``; with ``transpose_rhs``
``W`` is (E, N, K) and is contracted on its last axis (the backward's dX
and ``dy @ Wd^T`` orientation).

* ``esmm`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/esmm.cu`` (see its source note for the design) on the
  route ``_route`` picks from the dtype, the shapes and the weights'
  storage alone, before the launch, and counts the launch in
  ``esmm.launches`` and ``esmm.launches_by_route``; on a CPU tensor it
  runs ``esmm_plain``. There is no other path, and no route gives way to
  another. The routes:

  - ``"wgmma"``: bf16 xs and W at blk 64 or 128, K and N multiples of 8
    (the LM path), on the tensor cores fed by TMA;
  - ``"mma_tf32x3"``: f32 xs and W with K and N multiples of 4 (the Swin
    path), and every 8-bit W with K and N multiples of 8, on the tensor
    cores in 3xTF32 (``csrc/mma_sync.cuh``);
  - ``"simt"`` (f32 FMA): only what those two refuse, bf16 at blk 8..32
    and widths whose rows are not 16-byte multiples (8-byte for an 8-bit
    W).

  The two tensor-core routes load xs and W in 16-byte copies and need
  16-byte aligned base addresses; the wrapper raises on others.
* ``esmm_plain`` — the plain PyTorch version: a batched matmul against the
  per-block weight tiles ``W[block_expert]`` (``ops._blocked_esmm`` of the
  JAX package), accumulated in f32 from the bias and rounded once to
  ``xs.dtype``, as the kernels round.

Quantized weights (``w_scales``): W an int8 or fp8 e4m3 payload with f32
block scales on its own two axes (``quant.core``; (E, K/ta, N/tb), or
(E, N/ta, K/tb) with ``transpose_rhs``). On a CUDA tensor the kernel
dequantizes each W element as it stages it (``esmm_q_launch``, on
``mma_tf32x3`` or ``simt`` as above), counted in ``launches_by_route``
and in ``esmm.launches_quant`` by format; on a CPU tensor ``esmm_plain``
dequantizes W to f32 first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.quant.core import (QUANT_MODES, check_scales,
                                    dequantize_blockwise)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: 8-bit weight storage -> esmm_q_launch's wdtype.
_WDTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_I] * 8 + [_VP]
_Q_ARGTYPES = [_VP] * 6 + [_I] * 10 + [_VP]
_ROUTES = {"simt": 0, "wgmma": 1, "mma_tf32x3": 2}
#: The TPU kernel's K and N blocks: the quant tiles must divide them
#: (``scale_block_dims``), as ``esmm_pallas`` asserts.
_TPU_BLOCK = 128


def _route(dtype, blk: int, k: int, n: int, quantized: bool = False) -> str:
    """The kernel route for these operands: ``"wgmma"`` for bf16 xs and W
    with ``blk % 64 == 0`` and K and N multiples of 8 (TMA takes 16-byte
    global strides); ``"mma_tf32x3"`` for f32 xs and W with K and N
    multiples of 4, and for an 8-bit W (``quantized``) with K and N
    multiples of 8 (rows of 16-byte copies of xs, 8-byte ones of W);
    else ``"simt"`` (bf16 at blk 8..32, and the other widths)."""
    if quantized:
        return "mma_tf32x3" if k % 8 == 0 and n % 8 == 0 else "simt"
    if dtype == torch.float32:
        return "mma_tf32x3" if k % 4 == 0 and n % 4 == 0 else "simt"
    if blk % 64 == 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


def esmm_plain(xs, w, b, block_expert, *, w_scales=None,
               transpose_rhs: bool = False):
    """Plain PyTorch grouped matmul on the sorted layout: (Np, K) -> (Np, N).
    An 8-bit W (``w_scales``) is dequantized to f32 first."""
    if w_scales is not None:
        w = dequantize_blockwise(w, w_scales)
    np_rows = xs.shape[0]
    nblk = block_expert.shape[0]
    be = block_expert.long()
    wb = w[be].float()
    if transpose_rhs:
        wb = wb.transpose(1, 2)
    acc = torch.bmm(xs.reshape(nblk, np_rows // nblk, -1).float(), wb)
    if b is not None:
        acc = b[be].float()[:, None] + acc
    return acc.to(xs.dtype).reshape(np_rows, -1)


def _check_cuda_args(xs, w, b, block_expert, transpose_rhs, w_scales=None):
    if xs.ndim != 2 or w.ndim != 3:
        raise ValueError(f"esmm takes xs (Np, K) and w (E, K, N), got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}")
    np_rows, k = xs.shape
    e, kw, n = (w.shape[0], w.shape[2], w.shape[1]) if transpose_rhs \
        else tuple(w.shape)
    if kw != k:
        raise ValueError(f"w {tuple(w.shape)} (transpose_rhs="
                         f"{transpose_rhs}) does not contract with xs "
                         f"{tuple(xs.shape)}")
    if b is not None and b.shape != (e, n):
        raise ValueError(f"bias {tuple(b.shape)} is not (E, N) = ({e}, {n})")
    if w_scales is not None:
        bk, bn = min(_TPU_BLOCK, k), min(_TPU_BLOCK, n)
        check_scales("esmm", (w,), (w_scales,),
                     [(bn, bk) if transpose_rhs else (bk, bn)])
    if xs.dtype not in _DTYPES or (w_scales is None and w.dtype != xs.dtype) \
            or (b is not None and b.dtype not in (xs.dtype, torch.float32)):
        raise TypeError(f"esmm takes float32 or bfloat16 xs and w of one "
                        f"dtype and a bias of that dtype or float32, got "
                        f"{xs.dtype}, {w.dtype}, "
                        f"{None if b is None else b.dtype}")
    if block_expert.dtype != torch.int32 or block_expert.ndim != 1:
        raise TypeError("block_expert must be a 1-D int32 tensor")
    nblk = block_expert.shape[0]
    if nblk == 0 or np_rows % nblk:
        raise ValueError(f"layout of {np_rows} rows in {nblk} blocks")
    blk = np_rows // nblk
    if blk % 8 or not 8 <= blk <= 128:
        raise ValueError(f"blk {blk}: the kernel takes multiples of 8 up "
                         f"to 128")
    tensors = [t for t in (xs, w, b, block_expert, w_scales) if t is not None]
    if any(t.device != xs.device for t in tensors):
        raise ValueError("esmm operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("esmm operands must be contiguous")
    route = _route(xs.dtype, blk, k, n, w_scales is not None)
    if route != "simt" and (xs.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"esmm's {route} route loads xs and w in 16-byte "
                         f"copies (TMA on wgmma), which need 16-byte "
                         f"aligned base addresses")
    return np_rows, k, n, blk


def esmm(xs, w, b, block_expert, *, w_scales=None,
         transpose_rhs: bool = False) -> torch.Tensor:
    """Grouped matmul ys = xs @ W[e] (+ b[e]) on the sorted layout.

    xs: (Np, K); w: (E, K, N), or (E, N, K) with ``transpose_rhs``;
    b: (E, N) or None, in xs.dtype or f32 (added in f32, as the TPU
    kernel adds it); block_expert: (Np // blk,) int32; ``w_scales``: the
    f32 block scales of an int8/fp8 W, on W's own axes. Returns (Np, N) in
    ``xs.dtype``, accumulated in f32."""
    if w_scales is not None:
        ((ta, tb),) = check_scales("esmm", (w,), (w_scales,))
    if xs.device.type == "cpu":
        return esmm_plain(xs, w, b, block_expert, w_scales=w_scales,
                          transpose_rhs=transpose_rhs)
    if xs.device.type != "cuda":
        raise ValueError(f"esmm runs on CUDA or CPU, not {xs.device}")
    np_rows, k, n, blk = _check_cuda_args(xs, w, b, block_expert,
                                          transpose_rhs, w_scales)
    route = _route(xs.dtype, blk, k, n, w_scales is not None)
    if b is not None:
        b = b.float()                     # the kernel reads the bias in f32
    ys = torch.empty((np_rows, n), dtype=xs.dtype, device=xs.device)
    bp = None if b is None else b.data_ptr()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if w_scales is None:
            launch = build.load("esmm", "esmm_launch", _ARGTYPES)
            err = launch(xs.data_ptr(), w.data_ptr(), bp,
                         block_expert.data_ptr(), ys.data_ptr(), np_rows, k,
                         n, blk, int(transpose_rhs), _DTYPES[xs.dtype],
                         _ROUTES[route], w.shape[0], stream)
        else:
            launch = build.load("esmm", "esmm_q_launch", _Q_ARGTYPES)
            err = launch(xs.data_ptr(), w.data_ptr(), w_scales.data_ptr(), bp,
                         block_expert.data_ptr(), ys.data_ptr(), np_rows, k,
                         n, blk, int(transpose_rhs), _DTYPES[xs.dtype],
                         _WDTYPES[w.dtype], ta, tb, _ROUTES[route], stream)
    if err:
        raise RuntimeError(f"esmm kernel launch failed on the {route} route "
                           f"(CUDA error {err})")
    esmm.launches += 1
    esmm.launches_by_route[route] += 1
    if w_scales is not None:
        esmm.launches_quant[QUANT_MODES[w.dtype]] += 1
    return ys


esmm.launches = 0
esmm.launches_by_route = dict.fromkeys(_ROUTES, 0)
esmm.launches_quant = dict.fromkeys(QUANT_MODES.values(), 0)
