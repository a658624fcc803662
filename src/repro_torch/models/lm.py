"""LM assembly (counterpart of ``repro.models.lm``): parameter init, the
dense and the paged KV caches, and the forward pass (training, and dense
and paged serving).

The layer stack is a Python list of per-layer parameter dicts and the
forward an unrolled loop over it (the JAX package stacks layers per period
for ``lax.scan``; ``convert.params_from_jax`` unstacks them). The caches
are per-layer lists too: the JAX dense cache's leaf ``[pos][name][j]``
(period position ``pos``, period ``j``) is layer ``j * period + pos``
here. The ported
stacks are decoder-only all-attention models with GLU-expert MoE FFNs on
every FFN layer (qwen3-moe, mixtral); other configurations raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import ParallelConfig, normal_init
from repro_torch.quant.core import quantize_ffn


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this slice does not port."""
    missing = []
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        missing.append("recurrent mixers (mamba/xlstm)")
    if cfg.moe is None or not cfg.glu or any(
            not cfg.is_moe_layer(i) for i in range(cfg.num_layers)):
        missing.append("dense or MLP-expert FFN layers")
    if cfg.cross_attn or cfg.frontend or cfg.num_codebooks > 1 \
            or cfg.prefix_len:
        missing.append("frontends, cross-attention, codebook heads, prefixes")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {'; '.join(missing)} are not ported yet "
            f"(ROADMAP.md)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    """One block's parameters: attention mixer + MoE FFN."""
    return {
        "ln1": tfm.init_norm(cfg, device),
        "mixer": tfm.init_attention(cfg, dtype, generator, device),
        "ln2": tfm.init_norm(cfg, device),
        "ffn": tfm.init_moe_ffn(cfg, dtype, generator, device),
    }


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device, quant: Optional[str] = None) -> dict:
    """Full parameter tree, drawn from ``generator`` (on ``device``): the
    JAX package's shapes and its 0.02-std normal, not its numbers.
    ``quant`` ("int8" | "fp8"): each MoE layer's expert weights are
    quantized (``quant.core.quantize_ffn``) as soon as the layer is drawn,
    so the full-precision tree never exists; the weights equal
    ``quantize_lm_params`` of the tree drawn without it."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    p = {
        "embed": normal_init((cfg.vocab_size, cfg.d_model), dtype, generator,
                             device),
        "final_norm": tfm.init_norm(cfg, device),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        block = init_block(cfg, dtype, generator, device)
        if quant not in (None, "none") and cfg.is_moe_layer(i):
            block["ffn"] = quantize_ffn(block["ffn"], mode=quant)
        p["layers"].append(block)
    if not cfg.tie_embeddings:
        p["head"] = normal_init((cfg.d_model, cfg.vocab_size), dtype,
                                generator, device)
    return p


# ---------------------------------------------------------------------------
# dense serving cache
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes and dtypes of the dense decode cache: per attention layer K
    and V ``(batch, S_cache, Hkv, hd)`` (``S_cache = min(seq_len, window)``
    on windowed layers), and the per-slot filled length."""
    dtype = torch_dtype(cfg.dtype)
    return {"layers": [tfm.cache_spec_attention(cfg, i, batch, seq_len, dtype)
                       for i in range(cfg.num_layers)],
            "len": ((batch,), torch.int32)}


def _zeros_like_spec(spec: dict, device) -> dict:
    zeros = lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device)  # noqa: E731
    return {"layers": [{k: zeros(sd) for k, sd in layer.items()}
                       for layer in spec["layers"]],
            "len": zeros(spec["len"])}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """The dense ``(batch, seq_len)`` KV rectangle, zeroed, on ``device``."""
    return _zeros_like_spec(cache_spec(cfg, batch, seq_len), device)


def cache_bytes(cache: dict) -> int:
    """Device bytes of a cache's K/V (and scale) tensors."""
    return sum(t.numel() * t.element_size()
               for layer in cache["layers"] for t in layer.values())


# ---------------------------------------------------------------------------
# paged serving cache
# ---------------------------------------------------------------------------

def _check_kv_quant(kv_quant: Optional[str]) -> bool:
    if kv_quant not in (None, "none", "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    return kv_quant == "int8"


def paged_cache_spec(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, kv_quant: Optional[str] = None) -> dict:
    """Shapes and dtypes of the paged decode cache: per attention layer a
    SHARED pool of ``num_pages`` pages, ``(num_pages, page_size, Hkv, hd)``
    for K and for V (physical page 0 is the write sink for inactive slots),
    and the per-slot resident length. ``kv_quant="int8"``: int8 pools plus
    f32 ``k_scale``/``v_scale`` pools ``(num_pages, page_size, Hkv)`` of
    per-(row, kv head) scales."""
    quant = _check_kv_quant(kv_quant)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.hd)
    pool = (shape, torch.int8 if quant else torch_dtype(cfg.dtype))
    entry = {"k": pool, "v": pool}
    if quant:
        entry["k_scale"] = entry["v_scale"] = (shape[:3], torch.float32)
    return {"layers": [dict(entry) for _ in range(cfg.num_layers)],
            "len": ((num_slots,), torch.int32)}


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, device,
                     kv_quant: Optional[str] = None) -> dict:
    return _zeros_like_spec(
        paged_cache_spec(cfg, num_slots, num_pages, page_size, kv_quant),
        device)


def paged_kv_page_bytes(cfg: ModelConfig, page_size: int,
                        kv_quant: Optional[str] = None) -> int:
    """Device bytes ONE physical page costs across every attention layer —
    the unit ``parallel.cache.PagePool`` budgets admission in. With
    ``kv_quant="int8"`` a K or V row costs ``Hkv * (hd + 4)`` bytes: the
    int8 payload and one f32 scale per kv head."""
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    row = cfg.num_kv_heads * cfg.hd * itemsize
    if _check_kv_quant(kv_quant):
        row = cfg.num_kv_heads * (cfg.hd + 4)
    return n_attn * 2 * page_size * row


def reset_slot(cfg: ModelConfig, cache: dict, slot: int,
               length: int = 0) -> dict:
    """Reset one slot's length so a new request can reuse it. K/V needs no
    scrub: the dense buffer and freshly granted pages are both masked by
    ``len``."""
    cache["len"][slot] = length
    return cache


def rollback_slot(cfg: ModelConfig, cache: dict, slot: int,
                  length: int) -> dict:
    """Truncate one slot's resident length to ``length`` (in place), the
    device half of speculative-decoding rollback. Rejected drafted rows
    need no scrub: paged attention masks every position at and past the
    length, as it masks a fresh page's tail. Only an all-attention stack
    can rewind this way: a recurrent mixer's per-slot state advances token
    by token and cannot be truncated."""
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        raise ValueError(
            "rollback (length truncation) requires an all-attention "
            "stack: recurrent per-slot state cannot be rewound")
    if length < 0:
        raise ValueError(f"negative rollback length {length}")
    cache["len"][slot] = length
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_block(p: dict, x: torch.Tensor, ctx: tfm.Ctx, idx: int,
                cache: dict):
    """One block: attention + MoE FFN. Returns (x, cache, aux, z)."""
    h = tfm.apply_norm(p["ln1"], x, ctx.cfg)
    out, cache = tfm.apply_attention(p["mixer"], h, ctx, idx, cache)
    x = x + out
    h2 = tfm.apply_norm(p["ln2"], x, ctx.cfg)
    y, aux, z = tfm.apply_moe_ffn(p["ffn"], h2, ctx)
    return x + y, cache, aux, z


def _train_block(p: dict, x: torch.Tensor, ctx: tfm.Ctx, idx: int):
    x, _, aux, z = apply_block(p, x, ctx, idx, None)
    return x, aux, z


def run_layers(layers: list, x: torch.Tensor, ctx: tfm.Ctx,
               cache_layers: list):
    """The unrolled layer loop. Returns (x, aux, z, cache_layers).

    A training forward with ``pcfg.remat == "block"`` checkpoints each
    block (``torch.utils.checkpoint``, non-reentrant): only its input is
    saved and its forward, kernels included, runs again in the backward,
    as the JAX package's ``jax.checkpoint`` of a period does."""
    remat = ctx.mode == "train" and ctx.pcfg.remat != "none"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for idx, (lp, lc) in enumerate(zip(layers, cache_layers)):
        if remat:
            x, a, zz = checkpoint(_train_block, lp, x, ctx, idx,
                                  use_reentrant=False)
            nc = lc
        else:
            x, nc, a, zz = apply_block(lp, x, ctx, idx, lc)
        new_caches.append(nc)
        aux = aux + a
        z = z + zz
    return x, aux, z, new_caches


def _embed_in(params: dict, tokens: torch.Tensor, cfg: ModelConfig, dtype):
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def _logits_out(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Vocabulary logits in f32 (the JAX head's f32 accumulation)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    return x.float() @ w.float()


def score_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig):
    """Vocabulary logits (B, S, V) f32 at EVERY position of final-norm
    ``hidden`` states: the multi-position head of the speculative verify
    step, through the single-row head's ``_logits_out``."""
    if cfg.num_codebooks > 1:
        raise ValueError("score_logits does not support codebook heads")
    return _logits_out(params, hidden, cfg)


def forward(params: dict, inputs: dict, cfg: ModelConfig,
            pcfg: ParallelConfig, *, mode: str, cache: Optional[dict] = None,
            paged: Optional[dict] = None,
            active: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """Forward pass. Returns (logits, cache, aux_loss, z_loss); with
    ``return_hidden`` the final normed hidden states stand in for the
    logits.

    ``mode="train"``: the full sequence at positions ``arange(S)``, no
    cache (the returned cache is None).
    ``mode="decode"``: one token per slot at position ``len``, ``active``
    (B,) bool masks slots that write nothing (paged: the sink page; dense:
    the old row written back) and do not advance.
    ``mode="prefill"`` with ``paged``: a chunk continuing at each slot's
    resident length, ``active`` (B, S) marks its valid rows. Without
    ``paged``: the whole prompt at positions ``arange(S)`` into the dense
    cache (``init_cache``; None returns no cache), every slot's length set
    to S. Prefill gives the logits of the last row only.
    ``paged`` (serving): ``{"table": (B, maxp) int32, "page_size": int}``;
    None means the dense cache."""
    if mode not in ("train", "decode", "prefill"):
        raise ValueError(f"forward mode {mode!r}: train | prefill | decode")
    train = mode == "train"
    dense_prefill = mode == "prefill" and paged is None
    if train and (cache is not None or paged is not None
                  or active is not None):
        raise ValueError("paged cache / active mask are serving-side only")
    if dense_prefill and active is not None:
        raise ValueError("the dense prefill takes whole prompts: no active "
                         "mask")
    dtype = torch_dtype(cfg.dtype)
    x = _embed_in(params, inputs["tokens"], cfg, dtype)
    b, s, _ = x.shape
    if train or dense_prefill:
        cache_len = None
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        cache_layers = ([None] * len(params["layers"]) if cache is None
                        else cache["layers"])
    else:
        cache_len = cache["len"]
        positions = cache_len.long()[:, None] + torch.arange(
            s, device=x.device)
        cache_layers = cache["layers"]
    ctx = tfm.Ctx(cfg=cfg, pcfg=pcfg, mode=mode, positions=positions,
                  cache_len=cache_len, paged=paged, decode_active=active)
    x, aux, z, new_layers = run_layers(params["layers"], x, ctx,
                                       cache_layers)
    x = tfm.apply_norm(params["final_norm"], x, cfg)

    if return_hidden:
        logits = x
    elif mode == "prefill":
        logits = _logits_out(params, x[:, -1:], cfg)
    else:
        logits = _logits_out(params, x, cfg)

    n_moe = max(sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)), 1)
    if cache is None:
        return logits, None, aux / n_moe, z / n_moe
    if dense_prefill:
        new_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
    elif active is None:
        new_len = (cache_len + s).to(torch.int32)
    elif mode == "decode":
        new_len = (cache_len + active.int()).to(torch.int32)
    else:
        new_len = (cache_len + active.int().sum(dim=1)).to(torch.int32)
    new_cache = {"layers": new_layers, "len": new_len}
    return logits, new_cache, aux / n_moe, z / n_moe
