"""ESMM — expert-specific matrix multiplication over the expert-sorted
layout (paper Fig. 4(b); counterpart of ``repro.kernels.esmm.esmm_pallas``).

``ys[i] = xs[i] @ W[e(i)] (+ b[e(i)])`` where every BLK-row block of ``xs``
belongs to the one expert ``block_expert[block]``; with ``transpose_rhs``
``W`` is (E, N, K) and is contracted on its last axis (the backward's dX
and ``dy @ Wd^T`` orientation).

* ``esmm`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/esmm.cu`` (see its source note for the design) and
  counts the launch in ``esmm.launches``; on a CPU tensor it runs
  ``esmm_plain``. There is no other path.
* ``esmm_plain`` — the plain PyTorch version: a batched matmul against the
  per-block weight tiles ``W[block_expert]`` (``ops._blocked_esmm`` of the
  JAX package), accumulated in f32 from the bias and rounded once to
  ``xs.dtype``, as the kernels round.

Quantized weights (``w_scales``) belong to the quantization slice and
raise here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import QUANT_NOT_PORTED
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_I] * 6 + [_VP]


def esmm_plain(xs, w, b, block_expert, *, transpose_rhs: bool = False):
    """Plain PyTorch grouped matmul on the sorted layout: (Np, K) -> (Np, N)."""
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


def _check_cuda_args(xs, w, b, block_expert, transpose_rhs):
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
    if xs.dtype not in _DTYPES or w.dtype != xs.dtype or (
            b is not None and b.dtype not in (xs.dtype, torch.float32)):
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
    tensors = [t for t in (xs, w, b, block_expert) if t is not None]
    if any(t.device != xs.device for t in tensors):
        raise ValueError("esmm operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("esmm operands must be contiguous")
    return np_rows, k, n, blk


def esmm(xs, w, b, block_expert, *, w_scales=None,
         transpose_rhs: bool = False) -> torch.Tensor:
    """Grouped matmul ys = xs @ W[e] (+ b[e]) on the sorted layout.

    xs: (Np, K); w: (E, K, N), or (E, N, K) with ``transpose_rhs``;
    b: (E, N) or None, in xs.dtype or f32 (added in f32, as the TPU
    kernel adds it); block_expert: (Np // blk,) int32. Returns (Np, N) in
    ``xs.dtype``, accumulated in f32."""
    if w_scales is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
    if xs.device.type == "cpu":
        return esmm_plain(xs, w, b, block_expert, transpose_rhs=transpose_rhs)
    if xs.device.type != "cuda":
        raise ValueError(f"esmm runs on CUDA or CPU, not {xs.device}")
    np_rows, k, n, blk = _check_cuda_args(xs, w, b, block_expert,
                                          transpose_rhs)
    launch = build.load("esmm", "esmm_launch", _ARGTYPES)
    if b is not None:
        b = b.float()                     # the kernel reads the bias in f32
    ys = torch.empty((np_rows, n), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(xs.data_ptr(), w.data_ptr(),
                     None if b is None else b.data_ptr(),
                     block_expert.data_ptr(), ys.data_ptr(), np_rows, k, n,
                     blk, int(transpose_rhs), _DTYPES[xs.dtype], stream)
    if err:
        raise RuntimeError(f"esmm kernel launch failed (CUDA error {err})")
    esmm.launches += 1
    return ys


esmm.launches = 0
