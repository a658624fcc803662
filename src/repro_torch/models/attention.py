"""Attention helpers (counterpart of ``repro.models.attention``): rotary
embeddings, the chunked-causal GQA attention of training forwards and
dense prefill, and the single-step decode over a dense KV cache.

``chunked_attention`` is plain PyTorch, as the JAX package computes it in
XLA outside any Pallas kernel: an unrolled loop over query chunks where
chunk c reads only K/V[start : (c+1)*chunk], and within a chunk an
online-softmax loop over KV blocks. Each chunk is recomputed in the
backward (``torch.utils.checkpoint``), so per-chunk softmax residuals
never pile up across chunks. ``decode_attention`` is plain PyTorch for the
same reason: the JAX package computes it as two einsums.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embeddings. x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None]
    angles = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_block(q, k, qpos, kpos, *, causal, window, prefix_len, scale,
                softcap):
    """Masked f32 logits for one (q-chunk, kv-block) pair.
    q: (B, cs, Hkv, G, hd); k: (B, bk, Hkv, hd)."""
    logits = torch.einsum("bqhgd,bkhd->bqhgk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if causal:
        allowed = kpos[None, :] <= qpos[:, None]
        if window is not None:
            allowed &= kpos[None, :] > (qpos[:, None] - window)
        if prefix_len:
            allowed |= (kpos[None, :] < prefix_len) & (
                qpos[:, None] < prefix_len)
        logits = torch.where(allowed[None, :, None, None, :], logits,
                             NEG_INF)
    return logits


def _run_chunk(q_c, k_c, v_c, c, q_chunk, start, span, bk, causal, window,
               prefix_len, scale, softcap):
    """One query chunk: online softmax over its ``span // bk`` KV blocks."""
    b, _, hkv, g, hd = q_c.shape
    dev = q_c.device
    qpos = c * q_chunk + torch.arange(q_chunk, device=dev)
    m = torch.full((b, q_chunk, hkv, g), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, q_chunk, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, q_chunk, hkv, g, hd), dtype=torch.float32,
                      device=dev)
    for j in range(span // bk):
        kpos = start + j * bk + torch.arange(bk, device=dev)
        logits = _attn_block(
            q_c, k_c[:, j * bk:(j + 1) * bk], qpos, kpos, causal=causal,
            window=window if causal else None, prefix_len=prefix_len,
            scale=scale, softcap=softcap)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p, v_c[:, j * bk:(j + 1) * bk].float())
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      prefix_len: int = 0, q_chunk: int = 2048,
                      kv_block: int = 2048, scale: Optional[float] = None,
                      softcap: float = 0.0) -> torch.Tensor:
    """GQA attention, sub-quadratic-aware. q: (B, S, Hq, hd); k/v:
    (B, S, Hkv, hd). Returns (B, S, Hq, hd) in q's dtype."""
    s = q.shape[1]
    assert s == k.shape[1], "prefill/train assumes aligned q and kv"
    q_chunk = min(q_chunk, s)
    while s % q_chunk:
        q_chunk //= 2
    return torch.cat([
        chunk_attention(q[:, c * q_chunk:(c + 1) * q_chunk], k, v, c,
                        causal=causal, window=window, prefix_len=prefix_len,
                        kv_block=kv_block, scale=scale, softcap=softcap)
        for c in range(s // q_chunk)], dim=1)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int, *, causal: bool = True,
                    window: Optional[int] = None, prefix_len: int = 0,
                    kv_block: int = 2048, scale: Optional[float] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Query chunk ``chunk`` of a sequence cut into chunks of q's length,
    against the whole sequence's K/V: ``chunked_attention``'s body for one
    chunk, and on a mesh one rank's share of sequence-parallel attention.
    q: (B, C, Hq, hd) at positions ``chunk * C + arange(C)``; k/v:
    (B, S, Hkv, hd). Returns (B, C, Hq, hd) in q's dtype."""
    b, cs, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    end = (chunk + 1) * cs if causal else s
    start = 0
    if causal and window is not None and not prefix_len:
        start = max(0, end - window - cs)
    span = end - start
    bk = min(kv_block, span)
    while span % bk:
        bk //= 2
    out = checkpoint(
        _run_chunk, q.reshape(b, cs, hkv, hq // hkv, hd), k[:, start:end],
        v[:, start:end], chunk, cs, start, span, bk, causal, window,
        prefix_len, scale, softcap, use_reentrant=False)
    return out.reshape(b, cs, hq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-step decode. q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd).

    Positions ``>= cache_len`` are masked. The logits accumulate in f32,
    then softcap and softmax; p is cast to the cache dtype before the P V
    product (accumulated in f32), and the output back to q's dtype."""
    b, _, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, hd)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    valid = torch.arange(s, device=q.device)[None] < cache_len[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
