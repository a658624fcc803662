"""Step functions (counterpart of ``repro.launch.steps``): the training
step (loss, grads, AdamW update), the dense and paged serving engines'
steps and the speculative verify's multi-token score step.
PyTorch runs eagerly, so a step is a plain closure; the serving chunk's
valid count and slot arrive as host ints. One device only: the JAX
builders' ``mesh`` is None here.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import ParallelConfig


def xent_loss(logits, labels, mask):
    """Mean cross entropy over the masked positions. logits (B, S, V)."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum((lse - ll) * mask) / denom


def _chunk_loss(params, x_c, lbl_c, m_c, cfg):
    lg = lm._logits_out(params, x_c, cfg)
    mx = torch.amax(lg, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - mx), dim=-1)) + mx[..., 0]
    ll = torch.gather(lg, -1, lbl_c.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * m_c)


def chunked_xent(x, params, cfg: ModelConfig, labels, mask,
                 n_chunks: int = 16):
    """Cross entropy over sequence chunks: one (B, S_c, V) f32 logits block
    at a time, recomputed in the backward (``torch.utils.checkpoint``), so
    full-sequence logits (which dominate activation memory at 150k-entry
    vocabularies) never exist. x: (B, S, D) final hidden states."""
    s = x.shape[1]
    while s % n_chunks:
        n_chunks //= 2
    cs = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(_chunk_loss, params, x[:, sl],
                                   labels[:, sl], mask[:, sl], cfg,
                                   use_reentrant=False)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig):
    """Training loss closure: LM forward (hidden-state output) + chunked
    cross entropy + MoE aux/z losses, weighted per ``cfg.moe``. Routing
    takes no jitter. ``loss_fn(params, batch) -> (total, metrics)``;
    batch holds tokens, labels (B, S) int and loss_mask (B, S) f32."""
    aw = cfg.moe.aux_weight if cfg.moe else 0.0
    zw = cfg.moe.z_weight if cfg.moe else 0.0

    def loss_fn(params, batch):
        hidden, _, aux, z = lm.forward(params, batch, cfg, pcfg,
                                       mode="train", return_hidden=True)
        loss = chunked_xent(hidden, params, cfg, batch["labels"],
                            batch["loss_mask"])
        total = loss + aw * aux + zw * z
        return total, {"loss": loss, "aux_loss": aux, "z_loss": z}

    return loss_fn


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    opt_cfg: adamw.OptimizerConfig):
    """The train step: grads of ``make_loss_fn``'s total by autograd, then
    the AdamW update. ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; params and opt_state are updated in place
    (``adamw.apply_updates``) and metrics are 0-d tensors on the device.
    The update runs under the profiler range ``train_step.adamw``
    (``scripts/torch_train_profile.py`` reads its device time)."""
    loss_fn = make_loss_fn(cfg, pcfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        with record_function("train_step.adamw"):
            params, opt_state, om = adamw.apply_updates(
                params, grad_tree, opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om,
                                   "total_loss": total.detach()}

    return train_step


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig):
    """Dense-cache prefill: one forward over the whole prompt batch (every
    prompt of the same length S), writing its K/V rows into the ``(slots,
    max_seq)`` cache and setting every slot's length to S.
    ``prefill_step(params, inputs, cache) -> (logits (B, 1, V) f32 of the
    last row, cache)``; ``inputs``: tokens (B, S)."""

    def prefill_step(params, inputs, cache):
        logits, new_cache, _, _ = lm.forward(
            params, {"tokens": inputs["tokens"]}, cfg, pcfg, mode="prefill",
            cache=cache)
        return logits, new_cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, pcfg: ParallelConfig):
    """Dense-cache decode macro-step: one token per occupied slot
    (``active`` (B,) bool masks the rest; absent, every slot advances).
    ``serve_step(params, inputs, cache) -> (logits (B, 1, V) f32, cache)``;
    ``inputs``: tokens (B, 1) and optionally active."""

    def serve_step(params, inputs, cache):
        logits, new_cache, _, _ = lm.forward(
            params, {"tokens": inputs["tokens"]}, cfg, pcfg, mode="decode",
            cache=cache, active=inputs.get("active"))
        return logits, new_cache

    return serve_step


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


def make_paged_score_step(cfg: ModelConfig, pcfg: ParallelConfig,
                          page_size: int):
    """Multi-token scoring step for speculative verification: the
    chunk-extension paged forward of ``make_paged_prefill_step`` with
    logits at EVERY chunk position. Signature ``(params, tokens (k,),
    n_valid, slot, table_row (maxp,), cache) -> (logits (k, V) f32,
    cache)``: row ``i`` is the next-token distribution after
    ``tokens[:i+1]``, what a sequential decode would give having fed
    ``tokens[i]``. The slot's length advances by ``n_valid``; rows at and
    past ``n_valid`` write to the sink page and are to be ignored.
    All-attention stacks only."""
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        raise ValueError(
            "speculative scoring requires an all-attention stack: recurrent "
            "layers advance per-slot state token-wise, which page-table "
            "truncation cannot rewind")
    if cfg.num_codebooks > 1:
        raise ValueError("score step does not support codebook heads")
    fwd = _paged_chunk_forward(cfg, pcfg, page_size)

    def score_step(params, tokens, n_valid: int, slot: int, table_row,
                   cache):
        hidden, new_cache = fwd(params, tokens, n_valid, slot, table_row,
                                cache)
        return lm.score_logits(params, hidden, cfg)[0], new_cache

    return score_step
