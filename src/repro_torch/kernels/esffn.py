"""ESFFN — the fused GLU expert FFN (paper Fig. 3 / Table 5 forward;
counterpart of ``repro.kernels.esffn.esffn_glu_pallas``).

One op runs the whole expert FFN over the expert-sorted layout:
gather -> up/gate -> activation -> down -> gate weighting. Token rows are
gathered straight from the unsorted (N, D) activations through
``row_token``, and the output is the gate-weighted sorted (Np, D) rows
that ``core.reindex.scatter_rows`` combines.

* ``esffn_glu`` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel of ``csrc/esffn.cu`` (see its source note for the
  design) and counts the launch in ``esffn_glu.launches``; on a CPU tensor
  it runs ``esffn_glu_plain``. There is no other path.
* ``esffn_glu_plain`` — the plain PyTorch version: per-block weight tiles
  ``W[block_expert]`` and batched matmuls, rounding where the kernels
  round (g and u to x.dtype, h in x.dtype, the down product in f32, the
  output ``(acc * gate)`` to x.dtype).

Quantized weights (``w_scales``) belong to the quantization slice and
raise here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import ACT_IDS, ACTIVATIONS
from repro_torch.core.reindex import gather_rows
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 9 + [_I] * 7 + [_VP]


def esffn_glu_plain(x, row_token, row_gate, block_expert, w_gate, w_up,
                    w_down, *, act: str = "silu") -> torch.Tensor:
    """Plain PyTorch fused GLU expert FFN: (N, D) tokens -> (Np, D)
    gate-weighted sorted rows. Sentinel rows gather zeros (the kernels
    clamp them to row N-1); either way their zero gate makes them 0."""
    np_rows = row_token.shape[0]
    nblk = block_expert.shape[0]
    blk = np_rows // nblk
    xb = gather_rows(x, row_token).reshape(nblk, blk, -1)
    be = block_expert.long()
    g = torch.bmm(xb, w_gate[be].to(x.dtype))
    u = torch.bmm(xb, w_up[be].to(x.dtype))
    h = ACTIVATIONS[act](g) * u
    acc = torch.bmm(h.float(), w_down[be].float())
    out = acc * row_gate.reshape(nblk, blk, 1).float()
    return out.to(x.dtype).reshape(np_rows, -1)


def _check_cuda_args(x, row_token, row_gate, block_expert, w_gate, w_up,
                     w_down, act):
    n, d = x.shape
    e, dw, f = w_gate.shape
    if dw != d or w_up.shape != (e, d, f) or w_down.shape != (e, f, d):
        raise ValueError(f"weight shapes {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype
                                     for w in (w_gate, w_up, w_down)):
        raise TypeError(f"esffn_glu takes float32 or bfloat16 x and weights "
                        f"of the same dtype, got {x.dtype}, {w_gate.dtype}")
    if (row_token.dtype != torch.int32 or block_expert.dtype != torch.int32
            or row_gate.dtype != torch.float32):
        raise TypeError("row_token/block_expert must be int32, row_gate f32")
    np_rows, nblk = row_token.shape[0], block_expert.shape[0]
    if row_gate.shape != (np_rows,) or nblk == 0 or np_rows % nblk:
        raise ValueError(f"layout of {np_rows} rows in {nblk} blocks")
    blk = np_rows // nblk
    if blk % 8 or not 8 <= blk <= 128:
        raise ValueError(f"blk {blk}: the kernel takes multiples of 8 up "
                         f"to 128")
    if act not in ACT_IDS:
        raise ValueError(f"unknown activation {act!r}")
    tensors = (x, row_token, row_gate, block_expert, w_gate, w_up, w_down)
    if any(t.device != x.device for t in tensors):
        raise ValueError("esffn_glu operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("esffn_glu operands must be contiguous")
    return n, d, f, np_rows, blk


def esffn_glu(x, row_token, row_gate, block_expert, w_gate, w_up, w_down, *,
              w_scales=None, act: str = "silu") -> torch.Tensor:
    """Fused GLU expert FFN: (N, D) unsorted tokens -> (Np, D) gate-weighted
    sorted output. x: (N, D); row_token/row_gate: (Np,) int32/f32 and
    block_expert: (Np // blk,) int32 from ``core.reindex.build_reindex``;
    w_gate/w_up: (E, D, F); w_down: (E, F, D)."""
    if w_scales is not None:
        raise NotImplementedError(
            "quantized expert weights (w_scales) are not ported yet "
            "(ROADMAP.md: quantization slice)")
    if x.device.type == "cpu":
        return esffn_glu_plain(x, row_token, row_gate, block_expert,
                               w_gate, w_up, w_down, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"esffn_glu runs on CUDA or CPU, not {x.device}")
    n, d, f, np_rows, blk = _check_cuda_args(
        x, row_token, row_gate, block_expert, w_gate, w_up, w_down, act)
    launch = build.load("esffn", "esffn_glu_launch", _ARGTYPES)
    out = torch.empty((np_rows, d), dtype=x.dtype, device=x.device)
    h = torch.empty((np_rows, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), row_token.data_ptr(), row_gate.data_ptr(),
                     block_expert.data_ptr(), w_gate.data_ptr(),
                     w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
                     out.data_ptr(), n, d, f, np_rows, blk, _DTYPES[x.dtype],
                     ACT_IDS[act], stream)
    if err:
        raise RuntimeError(f"esffn_glu kernel launch failed (CUDA error {err})")
    esffn_glu.launches += 1
    return out


esffn_glu.launches = 0
