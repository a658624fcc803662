"""ESS — expert-specific summation over the expert-sorted layout (paper
Fig. 4(c); counterpart of ``repro.kernels.ess.ess_pallas``).

``db[e] = sum_{rows i of e} x[i]`` in f32, (E, D); an expert whose
``counts`` entry is 0 gets exactly 0. The unfused backward of the biased
MLP expert FFN (the paper's Fig. 12 ablation, ``ops.set_fused_backward(
False)``) computes its bias grads with it, beside ESTMM for dW.

* ``ess`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/ess.cu`` (see its source note for the design) and
  counts the launch in ``ess.launches``; on a CPU tensor it runs
  ``ess_plain``. There is no other path.
* ``ess_plain`` — the plain PyTorch version: per-block f32 column sums
  added into their expert's slot with ``index_add_``
  (``ops._ragged_ess`` of the JAX package sums per row), then the count
  mask.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 3 + [_I] * 4 + [_VP]


def ess_plain(x, block_expert, counts) -> torch.Tensor:
    """Plain PyTorch ESS: (Np, D) -> (E, D) f32."""
    nblk = block_expert.shape[0]
    per_block = x.reshape(nblk, x.shape[0] // nblk, -1).float().sum(1)
    out = per_block.new_zeros((counts.shape[0], x.shape[1]))
    out.index_add_(0, block_expert.long(), per_block)
    return torch.where((counts > 0)[:, None], out, 0.0)


def _check_cuda_args(x, block_expert, counts):
    if x.ndim != 2:
        raise ValueError(f"ess takes x (Np, D), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ess takes float32 or bfloat16 x, got {x.dtype}")
    if (block_expert.dtype != torch.int32 or counts.dtype != torch.int32
            or block_expert.ndim != 1 or counts.ndim != 1):
        raise TypeError("block_expert and counts must be 1-D int32 tensors")
    np_rows = x.shape[0]
    nblk = block_expert.shape[0]
    if nblk == 0 or np_rows % nblk or counts.shape[0] == 0:
        raise ValueError(f"layout of {np_rows} rows in {nblk} blocks over "
                         f"{counts.shape[0]} experts")
    tensors = (x, block_expert, counts)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ess operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("ess operands must be contiguous")
    return np_rows, x.shape[1], counts.shape[0]


def ess(x, block_expert, counts) -> torch.Tensor:
    """(Np, D) sorted rows -> (E, D) f32 per-expert sums.

    ``counts`` (E,) int32 are the layout's ``padded_counts``: the kernel
    reads each expert's run of rows from them, and an expert whose entry
    is 0 gets exactly 0."""
    if x.device.type == "cpu":
        return ess_plain(x, block_expert, counts)
    if x.device.type != "cuda":
        raise ValueError(f"ess runs on CUDA or CPU, not {x.device}")
    np_rows, d, e = _check_cuda_args(x, block_expert, counts)
    launch = build.load("ess", "ess_launch", _ARGTYPES)
    out = torch.empty((e, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), counts.data_ptr(), out.data_ptr(),
                     np_rows, d, e, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ess kernel launch failed (CUDA error {err})")
    ess.launches += 1
    return out


ess.launches = 0
