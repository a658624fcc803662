"""Step functions of the paged serving engine (counterpart of the serving
half of ``repro.launch.steps``). PyTorch runs eagerly, so a step is a plain
closure; the chunk's valid count and the slot arrive as host ints.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.parallel.sharding import ParallelConfig


def make_paged_serve_step(cfg: ModelConfig, pcfg: ParallelConfig,
                          page_size: int):
    """Continuous-batching decode macro-step over the paged KV cache.
    ``inputs``: tokens (B, 1), page_table (B, maxp) int32, active (B,)
    bool. Returns (logits (B, 1, V) f32, cache)."""

    def serve_step(params, inputs, cache):
        logits, new_cache, _, _ = lm.forward(
            params, {"tokens": inputs["tokens"]}, cfg, pcfg, mode="decode",
            cache=cache,
            paged={"table": inputs["page_table"], "page_size": page_size},
            active=inputs["active"])
        return logits, new_cache

    return serve_step


def make_paged_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                            page_size: int):
    """Chunked prefill into the paged cache: one request's next ``chunk``
    prompt tokens in ONE batch-1 forward. Signature ``(params, tokens
    (chunk,), n_valid, slot, table_row (maxp,), cache) -> (last_logits (V,)
    f32, cache)``; a short final chunk pads and masks. The scan form for
    recurrent stacks is not ported."""
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        raise NotImplementedError(
            "chunked prefill of recurrent stacks is not ported (ROADMAP.md)")
    return _make_paged_prefill_chunk(cfg, pcfg, page_size)


def _paged_chunk_forward(cfg: ModelConfig, pcfg: ParallelConfig,
                         page_size: int):
    """Shared body of the chunk-extension paged forward: final-norm hidden
    states at every chunk position and the cache with the slot's length
    advanced by ``n_valid``."""

    def fwd(params, tokens, n_valid: int, slot: int, table_row, cache):
        chunk = tokens.shape[0]
        # every layer is attention, so the layer cache is the shared
        # (batch-free) page pools — only the length is per-slot
        sub = {"layers": cache["layers"], "len": cache["len"][slot:slot + 1]}
        active = (torch.arange(chunk, device=tokens.device) < n_valid)[None]
        hidden, sub, _, _ = lm.forward(
            params, {"tokens": tokens[None]}, cfg, pcfg, mode="prefill",
            cache=sub, paged={"table": table_row[None], "page_size": page_size},
            active=active, return_hidden=True)
        new_len = cache["len"].clone()
        new_len[slot] = sub["len"][0]
        return hidden, {"layers": sub["layers"], "len": new_len}

    return fwd


def _make_paged_prefill_chunk(cfg: ModelConfig, pcfg: ParallelConfig,
                              page_size: int):
    fwd = _paged_chunk_forward(cfg, pcfg, page_size)

    def prefill_step(params, tokens, n_valid: int, slot: int, table_row,
                     cache):
        hidden, new_cache = fwd(params, tokens, n_valid, slot, table_row,
                                cache)
        # last valid row only: the first-generated-token logits
        logits = lm._logits_out(params, hidden[:, n_valid - 1:n_valid], cfg)
        return logits.reshape(-1), new_cache

    return prefill_step
