"""Paged decode attention over a shared KV page pool (counterpart of
``repro.kernels.paged_attention``).

* ``paged_attention`` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel of ``csrc/paged_attention.cu`` (the port of
  ``paged_attention_pallas``; see its source note for the design) and
  counts the launch in ``paged_attention.launches``; on a CPU tensor it
  runs ``paged_attention_ref``. There is no other path.
* ``paged_attention_ref`` — the plain PyTorch version (the port of the JAX
  ``paged_attention_ref``): gather each slot's pages to a dense
  (B, maxp*page) view and run masked softmax attention.

int8 pools (``k_scale``/``v_scale``) belong to the quantization slice and
raise here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_VP] * 6 + [_I] * 7 + [_F, _F, _I, _VP]


def paged_attention_ref(
    q: torch.Tensor,           # (B, 1, Hq, hd)
    k_pool: torch.Tensor,      # (npages, page, Hkv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, maxp) int32
    lengths: torch.Tensor,     # (B,) int32, live tokens incl. the current one
    *,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-dense paged decode attention: f32 logits, masked softmax,
    probabilities rounded to the pool dtype before the value product (as
    the JAX reference does), an empty slot gives zeros."""
    b, _, hq, hd = q.shape
    _, page, hkv, _ = k_pool.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    scale = hd ** -0.5 if scale is None else scale
    s = maxp * page
    pt = page_table.long()
    k_v = k_pool[pt].reshape(b, s, hkv, hd)
    v_v = v_pool[pt].reshape(b, s, hkv, hd)
    qg = q.reshape(b, hkv, g, hd)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_v.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    kpos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(lens[:, :, None, None] > 0, p, 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_v.dtype).float(), v_v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _check_cuda_args(q, k_pool, v_pool, page_table, lengths):
    b, one, hq, hd = q.shape
    _, page, hkv, hd_k = k_pool.shape
    if one != 1 or hd_k != hd or v_pool.shape != k_pool.shape or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"pools of the same dtype, got {q.dtype}, "
                        f"{k_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {b} slots")
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention operands must be contiguous")
    return b, hq, hkv, hd, page, page_table.shape[1]


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One query row per slot against its K/V pages: q (B, 1, Hq, hd),
    pools (npages, page, Hkv, hd), page_table (B, maxp) int32, lengths (B,)
    int32 -> (B, 1, Hq, hd)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pools (k_scale/v_scale) are not ported yet "
            "(ROADMAP.md: quantization slice)")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU, not {q.device}")
    b, hq, hkv, hd, page, maxp = _check_cuda_args(
        q, k_pool, v_pool, page_table, lengths)
    launch = build.load("paged_attention", "paged_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     b, hq, hkv, hd, page, maxp, int(window or 0),
                     float(softcap or 0.0), float(hd ** -0.5),
                     _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"paged_attention kernel launch failed (CUDA error {err})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
