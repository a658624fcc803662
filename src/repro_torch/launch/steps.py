"""Step functions (counterpart of ``repro.launch.steps``): the training
step (loss, grads, AdamW update), the dense and paged serving engines'
steps (the paged prefill a chunk forward on all-attention stacks, a
token-wise scan on stacks with recurrent mixers), the speculative
verify's multi-token score step, and the paged engine's slot handoff and
page copy.
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


def _per_token_xent(logits, labels):
    """Cross entropy a position: logits (B, S, [C,] V) f32 against labels
    (B, S, [C]); codebook losses averaged over C."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    per_tok = lse - ll
    if per_tok.ndim == 3:                  # (B, S, num_codebooks)
        per_tok = per_tok.mean(-1)
    return per_tok


def xent_loss(logits, labels, mask):
    """Mean cross entropy over the masked positions. logits (B, S, [C,] V),
    labels (B, S, [C]), mask (B, S)."""
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(_per_token_xent(logits.float(), labels) * mask) / denom


def _chunk_loss(params, x_c, lbl_c, m_c, cfg):
    return torch.sum(_per_token_xent(lm._logits_out(params, x_c, cfg),
                                     lbl_c) * m_c)


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
    batch holds the forward's inputs (``lm.forward``: tokens, patches,
    embeds, cond), labels (B, S) int ((B, S, C) with codebook heads) and
    loss_mask (B, S) f32. A siglip forward longer than the labels drops
    its first rows (the image prefix) before the loss; the CLI's batches
    cut the tokens so that it is as long, and the loss covers every row,
    as the JAX package's do."""
    lm.check_trainable(cfg)
    aw = cfg.moe.aux_weight if cfg.moe else 0.0
    zw = cfg.moe.z_weight if cfg.moe else 0.0

    def loss_fn(params, batch):
        hidden, _, aux, z = lm.forward(params, batch, cfg, pcfg,
                                       mode="train", return_hidden=True)
        labels = batch["labels"]
        if cfg.frontend == "siglip":
            n_img = hidden.shape[1] - labels.shape[1]
            if n_img > 0:
                hidden = hidden[:, n_img:]
        loss = chunked_xent(hidden, params, cfg, labels, batch["loss_mask"])
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
    ``prefill_step(params, inputs, cache) -> (logits (B, 1, [C,] V) f32 of
    the last row, cache)``; ``inputs``: the forward's (tokens (B, S);
    siglip patches before them, S their sum; encodec embeds; cond)."""

    def prefill_step(params, inputs, cache):
        logits, new_cache, _, _ = lm.forward(
            params, inputs, cfg, pcfg, mode="prefill", cache=cache)
        return logits, new_cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, pcfg: ParallelConfig):
    """Dense-cache decode macro-step: one token per occupied slot
    (``active`` (B,) bool masks the rest; absent, every slot advances).
    ``serve_step(params, inputs, cache) -> (logits (B, 1, [C,] V) f32,
    cache)``; ``inputs``: tokens (B, 1) (encodec: embeds (B, 1,
    frontend_dim)), cond where the config cross-attends, and optionally
    active."""

    def serve_step(params, inputs, cache):
        fwd_in = {k: v for k, v in inputs.items() if k != "active"}
        logits, new_cache, _, _ = lm.forward(
            params, fwd_in, cfg, pcfg, mode="decode", cache=cache,
            active=inputs.get("active"))
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
    prompt tokens. Signature ``(params, tokens (chunk,), n_valid, slot,
    table_row (maxp,), cache) -> (last_logits (V,) f32, cache)``; a short
    final chunk pads and masks. All-attention stacks run ONE batch-1
    forward over the chunk; stacks with recurrent mixers a loop of
    single-token decode forwards (their state advances token by token
    mid-stream, so the chunk is a scheduling unit, not a compute one)."""
    if not lm.recurrent_layers(cfg):
        return _make_paged_prefill_chunk(cfg, pcfg, page_size)
    return _make_paged_prefill_scan(cfg, pcfg, page_size)


def _paged_chunk_forward(cfg: ModelConfig, pcfg: ParallelConfig,
                         page_size: int):
    """Shared body of the chunk-extension paged forward: final-norm hidden
    states at every chunk position and the cache with the slot's length
    advanced by ``n_valid``. All-attention stacks only."""
    if lm.recurrent_layers(cfg):
        raise ValueError(
            "chunk-extension paged forward requires an all-attention "
            "stack (recurrent mixers advance token-wise)")

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
    All-attention stacks only (``_paged_chunk_forward`` raises)."""
    if cfg.num_codebooks > 1:
        raise ValueError("score step does not support codebook heads")
    fwd = _paged_chunk_forward(cfg, pcfg, page_size)

    def score_step(params, tokens, n_valid: int, slot: int, table_row,
                   cache):
        hidden, new_cache = fwd(params, tokens, n_valid, slot, table_row,
                                cache)
        return lm.score_logits(params, hidden, cfg)[0], new_cache

    return score_step


def make_paged_handoff_step(cfg: ModelConfig):
    """Prefill-to-decode role handoff: move one finished-prefill sequence
    from slot ``src`` to slot ``dst``. The K/V pages stay in the shared
    pools and are reached through the host table row the scheduler moves,
    so no K/V byte moves; on the device the slot's ``len`` and its
    recurrent state rows (Mamba conv/ssm, xLSTM c/n/h/m) move, and
    ``src``'s are zeroed. ``handoff(cache, src, dst) -> cache``, in
    place."""
    recurrent = lm.recurrent_layers(cfg)

    def handoff(cache, src: int, dst: int):
        for i in recurrent:
            for t in cache["layers"][i].values():
                t[dst] = t[src]
                t[src].zero_()
        ln = cache["len"]
        ln[dst] = ln[src]
        ln[src] = 0
        return cache

    return handoff


def make_page_copy_step(cfg: ModelConfig):
    """Copy one physical page's K/V rows (and int8 scale rows) from ``src``
    to ``dst`` in every attention pool: the device half of
    ``parallel.cache.PagePool.cow``, which hands the writer ``dst`` so the
    shared original is never written. Recurrent layers' per-slot state is
    not paged and stays. ``copy_page(cache, src, dst) -> cache``, in
    place."""
    recurrent = lm.recurrent_layers(cfg)

    def copy_page(cache, src: int, dst: int):
        for i, layer in enumerate(cache["layers"]):
            if i not in recurrent:
                for pool in layer.values():
                    pool[dst] = pool[src]
        return cache

    return copy_page


def _make_paged_prefill_scan(cfg: ModelConfig, pcfg: ParallelConfig,
                             page_size: int):
    """The paged prefill of stacks with recurrent mixers: the slot's state
    rows taken out, one batch-1 decode forward a valid chunk token, the
    rows written back; the last one's logits are returned. The JAX scan
    also runs the padding tokens past ``n_valid``, inactive (a sink-page
    write, state and length kept), which changes nothing; here they are
    skipped."""
    serve_step = make_paged_serve_step(cfg, pcfg, page_size)
    recurrent = lm.recurrent_layers(cfg)

    def prefill_step(params, tokens, n_valid: int, slot: int, table_row,
                     cache):
        sub = {"layers": [
            {k: t[slot:slot + 1] for k, t in layer.items()} if i in recurrent
            else layer for i, layer in enumerate(cache["layers"])],
            "len": cache["len"][slot:slot + 1]}
        inputs = {"page_table": table_row[None],
                  "active": torch.ones(1, dtype=torch.bool,
                                       device=tokens.device)}
        for t in range(n_valid):
            logits, sub = serve_step(
                params, {**inputs, "tokens": tokens[t].reshape(1, 1)}, sub)
        for i in recurrent:
            for k, t in cache["layers"][i].items():
                t[slot:slot + 1] = sub["layers"][i][k]
        new_len = cache["len"].clone()
        new_len[slot] = sub["len"][0]
        return logits.reshape(-1), {"layers": cache["layers"],
                                    "len": new_len}

    return prefill_step
