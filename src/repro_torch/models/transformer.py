"""Transformer building blocks (counterpart of ``repro.models.transformer``):
norms, GQA attention (full-sequence for training and dense prefill, over
the dense or the paged KV cache for serving), and the MoE FFN.

Parameters are plain dicts of tensors. The paged K/V pools and the dense
cache's decode rows are updated in place (the JAX version returns new
arrays): serving holds one cache and never needs the old one, so the port
saves the copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import NEG_INF, paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.parallel.moe_parallel import MoEStatic, moe_layer
from repro_torch.parallel.sharding import ParallelConfig, normal_init
from repro_torch.quant.core import dequantize_rows, quantize_rows


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through apply functions."""
    cfg: ModelConfig
    pcfg: ParallelConfig
    mode: str                           # train | prefill | decode
    positions: torch.Tensor             # (B, S) absolute positions
    cache_len: Optional[torch.Tensor]   # (B,) filled length before this step
    paged: Optional[dict]               # {"table": (B, maxp) i32, "page_size"}
    #   or None: the dense (B, S_cache) cache
    decode_active: Optional[torch.Tensor] = None  # (B,) decode / (B, S)
    #   prefill mask: inactive slots and rows write to the sink page only


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bias" in p:
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def _head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def init_moe_ffn(cfg: ModelConfig, dtype, generator, device) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.num_experts
    return {
        "router": normal_init((d, e), torch.float32, generator, device),
        "w_gate": normal_init((e, d, f), dtype, generator, device),
        "w_up": normal_init((e, d, f), dtype, generator, device),
        "w_down": normal_init((e, f, d), dtype, generator, device),
    }


def apply_moe_ffn(p: dict, x: torch.Tensor, ctx: Ctx):
    """Returns (y, aux_loss, z_loss). x: (B, S, D)."""
    m = ctx.cfg.moe
    ms = MoEStatic(num_experts=m.num_experts, top_k=m.top_k, act=ctx.cfg.act,
                   glu=ctx.cfg.glu, norm_topk=m.norm_topk,
                   softmax_after_topk=m.softmax_after_topk)
    return moe_layer(x, p, ms, ctx.pcfg)


# ---------------------------------------------------------------------------
# GQA attention over the dense or the paged KV cache
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": normal_init((d, hq * hd), dtype, generator, device),
        "wk": normal_init((d, hkv * hd), dtype, generator, device),
        "wv": normal_init((d, hkv * hd), dtype, generator, device),
        "wo": normal_init((hq * hd, d), dtype, generator, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def apply_attention(p: dict, x: torch.Tensor, ctx: Ctx, layer_idx: int,
                    cache: dict):
    """Self-attention. Returns (y, cache).

    train: the full sequence attends causally to itself
    (``attention.chunked_attention``); no cache.
    Dense serving (``ctx.paged`` None; ``cache`` from ``cache_spec_attention``):
    prefill attends as train does over the whole prompt and returns a new
    cache of its K/V rows (``_dense_prefill_cache``); decode writes the new
    row at ``len % S_cache`` in place (a rolling buffer on windowed layers;
    an inactive slot writes its old row back) and reads the cache through
    ``attention.decode_attention`` over ``min(len + active, S_cache)`` rows.
    Paged serving reads and writes the paged KV pools of ``cache`` in place.
    decode: one token per slot; its K/V row goes to page
    ``table[slot, len // page]`` at offset ``len % page`` (inactive slots
    to the sink page 0) and the read runs ``kernels.paged_attention``.
    prefill: a chunk continuing at ``cache_len``; its rows are scattered
    into the granted pages (rows past the valid count go to the sink) and
    the chunk attends causally over the gathered logical view.
    int8 pools (a cache with ``k_scale``/``v_scale``): each written row is
    quantized with its own per-(row, kv head) scale (``quantize_rows``);
    decode hands the scale pools to ``paged_attention``, prefill reads a
    view dequantized to q's dtype."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    local = cfg.attn_kind(layer_idx) == "local" and cfg.window > 0
    window = cfg.window if local else None

    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = _head_rms(q, p["q_norm"], cfg.norm_eps)
        k = _head_rms(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = attn_lib.rope(q, ctx.positions, cfg.rope_theta)
        k = attn_lib.rope(k, ctx.positions, cfg.rope_theta)

    if ctx.mode == "train" or (ctx.mode == "prefill" and ctx.paged is None):
        out = attn_lib.chunked_attention(
            q, k, v, causal=True, window=window, prefix_len=cfg.prefix_len,
            softcap=cfg.logit_softcap, q_chunk=2048)
        if cache is not None:
            cache = _dense_prefill_cache(k, v, cache)
        return out.reshape(b, s, hq * hd) @ p["wo"], cache
    if ctx.paged is None:
        assert ctx.mode == "decode" and s == 1
        return _dense_decode(q, k, v, ctx, cache, p["wo"])

    page = int(ctx.paged["page_size"])
    table = ctx.paged["table"]                        # (B, maxp) int32
    maxp = table.shape[1]
    k_pool, v_pool = cache["k"], cache["v"]
    k_sc, v_sc = cache.get("k_scale"), cache.get("v_scale")
    rows = torch.arange(b, device=x.device)

    def write(idx, k_rows, v_rows):
        """K/V rows into the pools at ``idx`` (in place), quantized with
        their own scales where the pools are int8."""
        if k_sc is None:
            k_pool[idx] = k_rows.to(k_pool.dtype)
            v_pool[idx] = v_rows.to(v_pool.dtype)
            return
        kq, ks = quantize_rows(k_rows)
        vq, vs = quantize_rows(v_rows)
        k_pool[idx], k_sc[idx] = kq, ks
        v_pool[idx], v_sc[idx] = vq, vs

    # Indices past the table clamp, as JAX's gathers do; the rows they
    # address are inactive and redirected to the sink page.
    if ctx.mode == "decode":
        assert s == 1
        active = ctx.decode_active
        if active is None:
            active = torch.ones(b, dtype=torch.bool, device=x.device)
        length = ctx.cache_len
        logical = (length // page).clamp(max=maxp - 1).long()
        phys = torch.where(active, table[rows, logical], 0).long()
        off = (length % page).long()
        write((phys, off), k[:, 0], v[:, 0])
        lengths = (length + active.int()).to(torch.int32)
        out = paged_attention(q, k_pool, v_pool, table, lengths,
                              k_scale=k_sc, v_scale=v_sc, window=window,
                              softcap=cfg.logit_softcap)
    elif ctx.mode == "prefill":
        active = ctx.decode_active                     # (B, S) valid rows
        if active is None:
            active = torch.ones((b, s), dtype=torch.bool, device=x.device)
        pos_abs = ctx.cache_len.long()[:, None] + torch.arange(
            s, device=x.device)[None]                  # (B, S)
        logical = (pos_abs // page).clamp(max=maxp - 1)
        phys = torch.where(active, table[rows[:, None], logical], 0).long()
        off = pos_abs % page
        write((phys.reshape(-1), off.reshape(-1)), k.reshape(b * s, hkv, hd),
              v.reshape(b * s, hkv, hd))

        s_all = maxp * page
        pt = table.long()

        def view(pool, sc):
            if sc is None:
                return pool[pt].reshape(b, s_all, hkv, hd)
            return dequantize_rows(pool[pt], sc[pt], dtype=q.dtype).reshape(
                b, s_all, hkv, hd)

        k_view, v_view = view(k_pool, k_sc), view(v_pool, v_sc)
        g = hq // hkv
        qg = q.reshape(b, s, hkv, g, hd)
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(),
                              k_view.float()) * (hd ** -0.5)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        kpos = torch.arange(s_all, device=x.device)[None, None]
        allowed = kpos <= pos_abs[:, :, None]          # causal, absolute
        if window is not None:
            allowed &= kpos > pos_abs[:, :, None] - window
        logits = torch.where(allowed[:, :, None, None, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bqhgk,bkhd->bqhgd",
                           probs.to(v_view.dtype).float(), v_view.float())
        out = out.reshape(b, s, hq, hd).to(q.dtype)
    y = out.reshape(b, s, hq * hd) @ p["wo"]
    return y, cache


def _dense_prefill_cache(k: torch.Tensor, v: torch.Tensor,
                         cache: dict) -> dict:
    """The prompt's K/V rows as a new dense layer cache. Padded to
    S_cache when the cache holds the whole prompt; otherwise (a windowed
    layer) the tail ``k[:, s - S_cache:]`` rolled by ``s``, so that
    absolute position p lives at row ``p % S_cache``, where decode writes."""
    s, s_cache = k.shape[1], cache["k"].shape[1]

    def rows(new, buf):
        if s_cache >= s:
            out = torch.zeros_like(buf)
            out[:, :s] = new.to(buf.dtype)
            return out
        return torch.roll(new[:, s - s_cache:], s, dims=1).to(buf.dtype)

    return {"k": rows(k, cache["k"]), "v": rows(v, cache["v"])}


def _dense_decode(q, k, v, ctx: Ctx, cache: dict, wo: torch.Tensor):
    """One decode token per slot over the dense cache (in place)."""
    b, _, hq, hd = q.shape
    k_cache, v_cache = cache["k"], cache["v"]
    s_cache = k_cache.shape[1]
    rows = torch.arange(b, device=q.device)
    slot = (ctx.cache_len % s_cache).long()            # rolling (window)
    active = ctx.decode_active
    adv = (torch.ones(b, dtype=torch.int32, device=q.device)
           if active is None else active.int())
    for buf, new in ((k_cache, k[:, 0]), (v_cache, v[:, 0])):
        new = new.to(buf.dtype)
        if active is not None:
            # a full window buffer still holds the OLDEST readable token at
            # len % S_cache: an inactive slot writes it back unchanged
            new = torch.where(active[:, None, None], new, buf[rows, slot])
        buf[rows, slot] = new
    valid = torch.clamp(ctx.cache_len + adv, max=s_cache)
    out = attn_lib.decode_attention(q, k_cache, v_cache, valid,
                                    softcap=ctx.cfg.logit_softcap)
    return out.reshape(b, 1, hq * hd) @ wo, cache


def cache_spec_attention(cfg: ModelConfig, layer_idx: int, batch: int,
                         seq_len: int, dtype) -> dict:
    """Shapes and dtypes of one attention layer's dense KV cache: a
    windowed (``local``) layer holds ``min(seq_len, window)`` rows."""
    local = cfg.attn_kind(layer_idx) == "local" and cfg.window > 0
    s_cache = min(seq_len, cfg.window) if local else seq_len
    shape = (batch, s_cache, cfg.num_kv_heads, cfg.hd)
    return {"k": (shape, dtype), "v": (shape, dtype)}
