"""ESTMM — expert-specific transposed matrix multiplication over the
expert-sorted layout (paper Fig. 4(d); counterpart of
``repro.kernels.estmm.estmm_pallas``).

``dW[e] = sum_{rows i of e} x1[i]^T x2[i]`` in f32, (E, D1, D2); an expert
whose ``counts`` entry is 0 gets exactly 0. The GLU expert FFN's backward
computes its weight gradients with it (experts without biases need no
``db``, so the fused ESFK kernel is not on that path), and so does the
biased MLP expert FFN's unfused backward (beside ESS for ``db``).

* ``estmm`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/estmm.cu`` (see its source note for the design) and
  counts the launch in ``estmm.launches``; on a CPU tensor it runs
  ``estmm_plain``. There is no other path.
* ``estmm_plain`` — the plain PyTorch version: per-block f32 products
  ``x1_b^T x2_b`` added into their expert's slot with ``index_add_``
  (``ops._blocked_estmm`` of the JAX package), then the count mask.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 4 + [_I] * 5 + [_VP]


def estmm_plain(x1, x2, block_expert, counts) -> torch.Tensor:
    """Plain PyTorch ESTMM: (Np, D1), (Np, D2) -> (E, D1, D2) f32."""
    np_rows = x1.shape[0]
    nblk = block_expert.shape[0]
    blk = np_rows // nblk
    per_block = torch.bmm(x1.reshape(nblk, blk, -1).float().transpose(1, 2),
                          x2.reshape(nblk, blk, -1).float())
    out = per_block.new_zeros((counts.shape[0],) + per_block.shape[1:])
    out.index_add_(0, block_expert.long(), per_block)
    return torch.where((counts > 0)[:, None, None], out, 0.0)


def _check_cuda_args(x1, x2, block_expert, counts, name: str = "estmm"):
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[0] != x2.shape[0]:
        raise ValueError(f"{name} takes x1 (Np, D1) and x2 (Np, D2), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    if x1.dtype not in _DTYPES or x2.dtype != x1.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x1 and x2 of one "
                        f"dtype, got {x1.dtype}, {x2.dtype}")
    if (block_expert.dtype != torch.int32 or counts.dtype != torch.int32
            or block_expert.ndim != 1 or counts.ndim != 1):
        raise TypeError("block_expert and counts must be 1-D int32 tensors")
    np_rows = x1.shape[0]
    nblk = block_expert.shape[0]
    if nblk == 0 or np_rows % nblk or counts.shape[0] == 0:
        raise ValueError(f"layout of {np_rows} rows in {nblk} blocks over "
                         f"{counts.shape[0]} experts")
    blk = np_rows // nblk
    if blk % 8 or not 8 <= blk <= 128:
        raise ValueError(f"blk {blk}: the kernel takes multiples of 8 up "
                         f"to 128")
    tensors = (x1, x2, block_expert, counts)
    if any(t.device != x1.device for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    return np_rows, x1.shape[1], x2.shape[1], counts.shape[0]


def estmm(x1, x2, block_expert, counts) -> torch.Tensor:
    """(Np, D1), (Np, D2) sorted rows -> (E, D1, D2) f32 weight grads.

    ``counts`` (E,) int32 are the layout's ``padded_counts`` (as the JAX
    op passes them): the kernel reads each expert's run of rows from them,
    and an expert whose entry is 0 gets exactly 0. ``block_expert`` gives
    the block size and, for the plain version, each block's expert."""
    if x1.device.type == "cpu":
        return estmm_plain(x1, x2, block_expert, counts)
    if x1.device.type != "cuda":
        raise ValueError(f"estmm runs on CUDA or CPU, not {x1.device}")
    np_rows, d1, d2, e = _check_cuda_args(x1, x2, block_expert, counts)
    launch = build.load("estmm", "estmm_launch", _ARGTYPES)
    out = torch.empty((e, d1, d2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x1.data_ptr(), x2.data_ptr(), counts.data_ptr(),
                     out.data_ptr(), np_rows, d1, d2, e, _DTYPES[x1.dtype],
                     stream)
    if err:
        raise RuntimeError(f"estmm kernel launch failed (CUDA error {err})")
    estmm.launches += 1
    return out


estmm.launches = 0
