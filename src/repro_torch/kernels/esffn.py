"""ESFFN — the fused expert FFNs (paper Fig. 3 / Table 5 forward;
counterparts of ``repro.kernels.esffn.esffn_glu_pallas`` and
``esffn_mlp_pallas``).

One op runs the whole expert FFN over the expert-sorted layout:
gather -> up (and gate) -> activation -> down -> gate weighting. Token
rows are gathered straight from the unsorted (N, D) activations through
``row_token``, and the output is the gate-weighted sorted (Np, D) rows
that ``core.reindex.scatter_rows`` combines. Two expert bodies:

* ``esffn_glu`` — ``(act(x Wg) * (x Wu)) Wd`` (Mixtral / Qwen3 experts);
* ``esffn_mlp`` — ``act(x W1 + b1) W2 + b2`` with optional f32 biases
  (the paper's 2-MLP expert, Swin-MoE); b2 is added once per row inside
  the gate product.

Each wrapper launches, on a CUDA tensor, the hand-written kernel of
``csrc/esffn.cu`` (see its source note for the design) and counts the
launch in ``<wrapper>.launches``; on a CPU tensor it runs its plain
version. There is no other path. The plain versions (``*_plain``) use
per-block weight tiles ``W[block_expert]`` and batched matmuls, rounding
where the kernels round: g and u (GLU) or z after ``+ b1`` (MLP) to
x.dtype, h in x.dtype, the down product in f32 (from b2), the output
``(acc * gate)`` to x.dtype.

Quantized weights (``w_scales``) belong to the quantization slice and
raise here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import ACT_IDS, ACTIVATIONS, QUANT_NOT_PORTED
from repro_torch.core.reindex import gather_rows
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 9 + [_I] * 7 + [_VP]
_MLP_ARGTYPES = [_VP] * 10 + [_I] * 7 + [_VP]


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


def _check_layout(name, x, row_token, row_gate, block_expert, act,
                  tensors):
    """The checks both FFN kernels share: the row maps, the block size,
    the activation, and one device and contiguity for ``tensors``.
    Returns (Np, blk)."""
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
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    return np_rows, blk


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
    np_rows, blk = _check_layout(
        "esffn_glu", x, row_token, row_gate, block_expert, act,
        (x, row_token, row_gate, block_expert, w_gate, w_up, w_down))
    return n, d, f, np_rows, blk


def esffn_glu(x, row_token, row_gate, block_expert, w_gate, w_up, w_down, *,
              w_scales=None, act: str = "silu") -> torch.Tensor:
    """Fused GLU expert FFN: (N, D) unsorted tokens -> (Np, D) gate-weighted
    sorted output. x: (N, D); row_token/row_gate: (Np,) int32/f32 and
    block_expert: (Np // blk,) int32 from ``core.reindex.build_reindex``;
    w_gate/w_up: (E, D, F); w_down: (E, F, D)."""
    if w_scales is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
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


def esffn_mlp_plain(x, row_token, row_gate, block_expert, w1, b1, w2, b2, *,
                    act: str = "gelu") -> torch.Tensor:
    """Plain PyTorch fused 2-MLP expert FFN: (N, D) tokens -> (Np, D)
    gate-weighted sorted rows. z sums in f32 and takes b1 in f32 before it
    is rounded to x.dtype; the down product sums in f32 from b2."""
    np_rows = row_token.shape[0]
    nblk = block_expert.shape[0]
    blk = np_rows // nblk
    xb = gather_rows(x, row_token).reshape(nblk, blk, -1)
    be = block_expert.long()
    z = torch.bmm(xb.float(), w1[be].float())
    if b1 is not None:
        z = z + b1[be].float()[:, None]
    h = ACTIVATIONS[act](z.to(x.dtype))
    acc = torch.bmm(h.float(), w2[be].float())
    if b2 is not None:
        acc = b2[be].float()[:, None] + acc
    out = acc * row_gate.reshape(nblk, blk, 1).float()
    return out.to(x.dtype).reshape(np_rows, -1)


def _check_mlp_cuda_args(x, row_token, row_gate, block_expert, w1, b1, w2,
                         b2, act):
    n, d = x.shape
    e, dw, f = w1.shape
    if dw != d or w2.shape != (e, f, d):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not match x {tuple(x.shape)}")
    for name, b, want in (("b1", b1, (e, f)), ("b2", b2, (e, d))):
        if b is not None and (b.shape != want or not b.is_floating_point()):
            raise ValueError(f"{name} {tuple(b.shape)} {b.dtype} is not a "
                             f"float (E, {want[1]}) bias")
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"esffn_mlp takes float32 or bfloat16 x and weights "
                        f"of the same dtype, got {x.dtype}, {w1.dtype}, "
                        f"{w2.dtype}")
    np_rows, blk = _check_layout(
        "esffn_mlp", x, row_token, row_gate, block_expert, act,
        [t for t in (x, row_token, row_gate, block_expert, w1, b1, w2, b2)
         if t is not None])
    return n, d, f, np_rows, blk


def esffn_mlp(x, row_token, row_gate, block_expert, w1, b1, w2, b2, *,
              w_scales=None, act: str = "gelu") -> torch.Tensor:
    """Fused 2-MLP expert FFN: (N, D) unsorted tokens -> (Np, D)
    gate-weighted sorted output ``(act(x W1 + b1) W2 + b2) * gate``.
    w1: (E, D, F); w2: (E, F, D) in x.dtype; b1: (E, F) and b2: (E, D) or
    None, added in f32; row maps as for ``esffn_glu``."""
    if w_scales is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
    if x.device.type == "cpu":
        return esffn_mlp_plain(x, row_token, row_gate, block_expert, w1, b1,
                               w2, b2, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"esffn_mlp runs on CUDA or CPU, not {x.device}")
    n, d, f, np_rows, blk = _check_mlp_cuda_args(
        x, row_token, row_gate, block_expert, w1, b1, w2, b2, act)
    launch = build.load("esffn", "esffn_mlp_launch", _MLP_ARGTYPES)
    b1, b2 = (None if b is None else b.float() for b in (b1, b2))
    out = torch.empty((np_rows, d), dtype=x.dtype, device=x.device)
    h = torch.empty((np_rows, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), row_token.data_ptr(), row_gate.data_ptr(),
                     block_expert.data_ptr(), w1.data_ptr(),
                     None if b1 is None else b1.data_ptr(), w2.data_ptr(),
                     None if b2 is None else b2.data_ptr(), h.data_ptr(),
                     out.data_ptr(), n, d, f, np_rows, blk, _DTYPES[x.dtype],
                     ACT_IDS[act], stream)
    if err:
        raise RuntimeError(f"esffn_mlp kernel launch failed (CUDA error {err})")
    esffn_mlp.launches += 1
    return out


esffn_mlp.launches = 0
