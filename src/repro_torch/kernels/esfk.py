"""ESFK — the expert-specific fused backward kernel over the expert-sorted
layout (paper Fig. 4(c)+(d); counterpart of
``repro.kernels.esfk.esfk_pallas``).

``dW[e] = sum_{rows i of e} x1[i]^T x2[i]`` and ``db[e] = sum_{rows i of e}
x2[i]`` in one pass, both f32: (E, D1, D2) and (E, D2); an expert whose
``counts`` entry is 0 gets exactly 0 in both. The biased MLP expert FFN's
backward computes (dW1, db1) and (dW2, db2) with it.

* ``esfk`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/esfk.cu`` (see its source note for the design) and
  counts the launch in ``esfk.launches``; on a CPU tensor it runs
  ``esfk_plain``. There is no other path.
* ``esfk_plain`` — the plain PyTorch version: ``estmm_plain`` for dW and
  ``ess_plain`` for db (the JAX package's unfused pair).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ess import ess_plain
from repro_torch.kernels.estmm import _check_cuda_args, estmm_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_I] * 5 + [_VP]


def esfk_plain(x1, x2, block_expert, counts):
    """Plain PyTorch ESFK: (Np, D1), (Np, D2) -> ((E, D1, D2), (E, D2)) f32."""
    return (estmm_plain(x1, x2, block_expert, counts),
            ess_plain(x2, block_expert, counts))


def esfk(x1, x2, block_expert, counts):
    """(Np, D1), (Np, D2) sorted rows -> (dW (E, D1, D2), db (E, D2)), f32.

    ``counts`` (E,) int32 are the layout's ``padded_counts``: the kernel
    reads each expert's run of rows from them, and an expert whose entry
    is 0 gets exactly 0. ``block_expert`` gives the block size and, for
    the plain version, each block's expert. The operands are checked as
    ``estmm``'s are."""
    if x1.device.type == "cpu":
        return esfk_plain(x1, x2, block_expert, counts)
    if x1.device.type != "cuda":
        raise ValueError(f"esfk runs on CUDA or CPU, not {x1.device}")
    np_rows, d1, d2, e = _check_cuda_args(x1, x2, block_expert, counts,
                                          "esfk")
    launch = build.load("esfk", "esfk_launch", _ARGTYPES)
    dw = torch.empty((e, d1, d2), dtype=torch.float32, device=x1.device)
    db = torch.empty((e, d2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x1.data_ptr(), x2.data_ptr(), counts.data_ptr(),
                     dw.data_ptr(), db.data_ptr(), np_rows, d1, d2, e,
                     _DTYPES[x1.dtype], stream)
    if err:
        raise RuntimeError(f"esfk kernel launch failed (CUDA error {err})")
    esfk.launches += 1
    return dw, db


esfk.launches = 0
