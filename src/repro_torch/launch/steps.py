"""Step functions (counterpart of ``repro.launch.steps``): the training
step (loss, grads, AdamW update), the dense and paged serving engines'
steps (the paged prefill a chunk forward on all-attention stacks, a
token-wise scan on stacks with recurrent mixers), the speculative
verify's multi-token score step, and the paged engine's slot handoff and
page copy.
PyTorch runs eagerly, so a step is a plain closure; the serving chunk's
valid count and slot arrive as host ints.

The training and dense serving builders take a ``mesh`` (a
``launch.mesh.Mesh``) and the global ``batch_shape3`` (B, S, d_model),
from which they place the activations (``launch.inputs.
activation_spec``), as the JAX builders do. On a mesh the parameters and
the optimizer state are this rank's shards (``sharded_params``,
``sharded_opt_state``); the train step takes this rank's block of the
batch (``launch.inputs.batch_block``), the serving steps the whole batch
of slots, each rank cutting its own and returning the logits of every
slot, so that every rank's host scheduler sees the same logits. Every
LM family takes them: the codebook heads' loss is the
vocabulary-parallel cross entropy once a codebook. The paged engine's
builders take a ``mesh`` and ``num_slots`` under the same rule: the
decode step cuts this rank's block of the slots, the batch-1 prefill
chunk and score forwards run whole on every rank, and the slots' lengths
are whole on every rank (``lm.paged_cache_specs``).

With ``pcfg.collect_router_stats`` every step follows the JAX package's
arities: the train step's metrics carry ``"router_stats"``
(the ``obs.device`` stats, tensors on the device), and the dense and
paged serve, prefill and score steps return the stats as a third
element; the token-wise paged prefill sums them token by token
(``obs.add_stats``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.inputs import activation_spec, batch_block
from repro_torch.models import lm
from repro_torch.models import transformer as tfm
from repro_torch.obs import device as obs_device
from repro_torch.optim import adamw
from repro_torch.parallel.moe_parallel import _Psum
from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    global_grad_norm,
    shard_tree,
)


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


def _chunk_loss_mesh(w, x_c, lbl_c, m_c, mesh, vaxes):
    """A chunk's summed cross entropy from this rank's vocabulary block of
    the logits: the max and the exp-sum reduced over ``vaxes``, the
    label's logit taken from the rank that holds it."""
    logits = x_c.float() @ w.float()                   # (B, S_c, V_l)
    m = torch.amax(logits, dim=-1).detach()
    if vaxes:
        m = torch.amax(mesh.all_gather(m[..., None], vaxes, 2), dim=-1)
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    vl = logits.shape[-1]
    local = lbl_c.long() - (mesh.index(vaxes) * vl if vaxes else 0)
    hit = (local >= 0) & (local < vl)
    ll = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    ll = torch.where(hit, ll, torch.zeros((), device=ll.device))
    if vaxes:
        se = _Psum.apply(se, mesh, vaxes)
        ll = _Psum.apply(ll, mesh, vaxes)
    return torch.sum((torch.log(se) + m - ll) * m_c)


def chunked_xent(x, params, cfg: ModelConfig, labels, mask,
                 n_chunks: int = 16, pcfg: ParallelConfig = None, mesh=None,
                 x_spec=None):
    """Cross entropy over sequence chunks: one (B, S_c, V) f32 logits block
    at a time, recomputed in the backward (``torch.utils.checkpoint``), so
    full-sequence logits (which dominate activation memory at 150k-entry
    vocabularies) never exist. x: (B, S, D) final hidden states.

    On a ``mesh`` (an island): x is this rank's block at ``x_spec``, the
    labels and mask its batch block with the whole sequence. The hidden
    states' sequence is gathered over "sp" once and the head (or the tied
    embedding) stays split over "tp" in the vocabulary: every rank
    computes every chunk's logits for its vocabulary block, the
    logsumexp from a max and an exp-sum reduced over "tp"; codebook
    heads do so once a codebook, the losses averaged over them. The loss
    is the global mean, the same on every rank."""
    if mesh is not None:
        return _chunked_xent_mesh(x, params, cfg, labels, mask, n_chunks,
                                  pcfg, mesh, x_spec)
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


def _chunked_xent_mesh(x, params, cfg, labels, mask, n_chunks, pcfg, mesh,
                       x_spec):
    baxes = as_axes(x_spec[0])
    x = tfm.seq_gather(tfm.island_in(x, mesh, x_spec), mesh,
                        as_axes(x_spec[1]))
    if cfg.num_codebooks > 1:
        # the vocabulary-parallel loss once a codebook, averaged over them
        w, vaxes = lm.cb_head_weight(params, cfg, pcfg, mesh)
        heads = [(w[c], labels[..., c]) for c in range(cfg.num_codebooks)]
    else:
        w, vaxes = lm.head_weight(params, cfg, pcfg, mesh)
        heads = [(w, labels)]
    s = x.shape[1]
    while s % n_chunks:
        n_chunks //= 2
    cs = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for wc, lbl in heads:
        for c in range(n_chunks):
            sl = slice(c * cs, (c + 1) * cs)
            total = total + checkpoint(_chunk_loss_mesh, wc, x[:, sl],
                                       lbl[:, sl], mask[:, sl], mesh, vaxes,
                                       use_reentrant=False)
    total = total / len(heads)
    if baxes:
        total = _Psum.apply(total, mesh, baxes)
    denom = mesh.all_reduce(torch.sum(mask.float()), baxes)
    return tfm.island_out(total / torch.clamp(denom, min=1.0), mesh, ())


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, *, mesh=None,
                 batch_shape3=None):
    """Training loss closure: LM forward (hidden-state output) + chunked
    cross entropy + MoE aux/z losses, weighted per ``cfg.moe``. Routing
    takes no jitter. ``loss_fn(params, batch) -> (total, metrics)``;
    batch holds the forward's inputs (``lm.forward``: tokens, patches,
    embeds, cond), labels (B, S) int ((B, S, C) with codebook heads) and
    loss_mask (B, S) f32. A siglip forward longer than the labels drops
    its first rows (the image prefix) before the loss; the CLI's batches
    cut the tokens so that it is as long, and the loss covers every row,
    as the JAX package's do.

    On a ``mesh`` the params are this rank's shards and the batch its
    block (``launch.inputs.batch_block`` under the activations' batch
    axes); ``batch_shape3`` is the global (B, S, d_model). The loss, aux
    and z are global, the same on every rank, and autograd from each
    rank's total gives this rank's blocks of the global gradient."""
    lm.check_mesh(cfg, pcfg, mesh)
    aw = cfg.moe.aux_weight if cfg.moe else 0.0
    zw = cfg.moe.z_weight if cfg.moe else 0.0
    x_spec = _x_spec(batch_shape3, pcfg, mesh)

    def loss_fn(params, batch):
        out = lm.forward(params, batch, cfg, pcfg, mode="train",
                         return_hidden=True, mesh=mesh, x_spec=x_spec)
        hidden, _, aux, z = out[:4]
        labels = batch["labels"]
        if cfg.frontend == "siglip":
            n_img = hidden.shape[1] - labels.shape[1]
            if mesh is not None:
                n_img = batch_shape3[1] - labels.shape[1]
                if n_img > 0:
                    raise ValueError(
                        "on a mesh the labels cover the whole forward "
                        "(patches and tokens), as the train CLI's do")
            if n_img > 0:
                hidden = hidden[:, n_img:]
        loss = chunked_xent(hidden, params, cfg, labels, batch["loss_mask"],
                            pcfg=pcfg, mesh=mesh, x_spec=x_spec)
        total = loss + aw * aux + zw * z
        metrics = {"loss": loss, "aux_loss": aux, "z_loss": z}
        if pcfg.collect_router_stats:
            # the device telemetry rides the metrics (not differentiated);
            # the CLIs pop it before they read the scalars
            metrics["router_stats"] = out[4]
        return total, metrics

    return loss_fn


def _x_spec(batch_shape3, pcfg: ParallelConfig, mesh):
    if mesh is None:
        return None
    if batch_shape3 is None:
        raise ValueError("a mesh needs batch_shape3, the global (B, S, "
                         "d_model) of the activations")
    return activation_spec(batch_shape3, pcfg, mesh)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    opt_cfg: adamw.OptimizerConfig, *, mesh=None,
                    batch_shape3=None):
    """The train step: grads of ``make_loss_fn``'s total by autograd, then
    the AdamW update. ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; params and opt_state are updated in place
    (``adamw.apply_updates``) and metrics are 0-d tensors on the device.
    The update runs under the profiler range ``train_step.adamw``
    (``scripts/torch_train_profile.py`` reads its device time).

    On a ``mesh`` (``make_loss_fn``'s placement) the moments and masters
    follow the parameters' shards, the step count is replicated, and the
    clip norm is the global gradient's (``sharding.global_grad_norm``:
    each leaf's squares summed over the axes its block is sharded on)."""
    loss_fn = make_loss_fn(cfg, pcfg, mesh=mesh, batch_shape3=batch_shape3)
    pspecs = None if mesh is None else lm.physical_specs(cfg, pcfg, mesh)

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
        gnorm = (None if mesh is None
                 else global_grad_norm(grad_tree, pspecs, mesh))
        with record_function("train_step.adamw"):
            params, opt_state, om = adamw.apply_updates(
                params, grad_tree, opt_state, opt_cfg, grad_norm=gnorm)
        metrics = {k: v if k == "router_stats" else v.detach()
                   for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om,
                                   "total_loss": total.detach()}

    return train_step


def _dense_step(cfg, pcfg, mesh, batch_shape3, mode):
    """The dense-cache forward of ``mode`` as a step; on a mesh each rank
    cuts its block of the slots from the whole batch of inputs and the
    logits come back gathered over the slots on every rank."""
    lm.check_mesh(cfg, pcfg, mesh)
    x_spec = _x_spec(batch_shape3, pcfg, mesh)

    def step(params, inputs, cache):
        fwd_in = {k: v for k, v in inputs.items() if k != "active"}
        active = inputs.get("active")
        if mesh is not None:
            fwd_in = batch_block(fwd_in, x_spec, mesh)
            if active is not None:
                active = batch_block({"a": active}, x_spec, mesh)["a"]
        out = lm.forward(params, fwd_in, cfg, pcfg, mode=mode, cache=cache,
                         active=active, mesh=mesh, x_spec=x_spec)
        logits, new_cache = out[:2]
        if mesh is not None:
            logits = mesh.all_gather(logits, as_axes(x_spec[0]), 0)
        return (logits, new_cache) + tuple(out[4:])

    return step


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, *, mesh=None,
                      batch_shape3=None):
    """Dense-cache prefill: one forward over the whole prompt batch (every
    prompt of the same length S), writing its K/V rows into the ``(slots,
    max_seq)`` cache and setting every slot's length to S.
    ``prefill_step(params, inputs, cache) -> (logits (B, 1, [C,] V) f32 of
    the last row, cache)``; ``inputs``: the forward's (tokens (B, S);
    siglip patches before them, S their sum; encodec embeds; cond). On a
    ``mesh`` (``batch_shape3`` (B, S, d_model)): the whole batch in, this
    rank's cache block (``lm.init_cache(mesh=)``), every slot's logits
    out."""
    return _dense_step(cfg, pcfg, mesh, batch_shape3, "prefill")


def make_serve_step(cfg: ModelConfig, pcfg: ParallelConfig, *, mesh=None,
                    batch_shape3=None):
    """Dense-cache decode macro-step: one token per occupied slot
    (``active`` (B,) bool masks the rest; absent, every slot advances).
    ``serve_step(params, inputs, cache) -> (logits (B, 1, [C,] V) f32,
    cache)``; ``inputs``: tokens (B, 1) (encodec: embeds (B, 1,
    frontend_dim)), cond where the config cross-attends, and optionally
    active. On a ``mesh`` (``batch_shape3`` (B, 1, d_model)): as
    ``make_prefill_step``."""
    return _dense_step(cfg, pcfg, mesh, batch_shape3, "decode")


def make_paged_serve_step(cfg: ModelConfig, pcfg: ParallelConfig,
                          page_size: int, *, mesh=None,
                          num_slots: Optional[int] = None):
    """Continuous-batching decode macro-step over the paged KV cache.
    ``inputs``: tokens (B, 1), page_table (B, maxp) int32, active (B,)
    bool. Returns (logits (B, 1, V) f32, cache). On a ``mesh`` (B =
    ``num_slots``): the whole batch in, this rank's block of the slots
    forwarded (``lm.paged_slot_block``), every slot's logits out."""
    lm.check_mesh(cfg, pcfg, mesh)
    baxes, lo, n = _slot_block(cfg, pcfg, mesh, num_slots)
    x_spec = _x_spec(None if mesh is None else (num_slots, 1, cfg.d_model),
                     pcfg, mesh)

    def serve_step(params, inputs, cache):
        blk = {"tokens": inputs["tokens"], "page_table": inputs["page_table"],
               "active": inputs["active"]}
        if mesh is not None:
            blk = batch_block(blk, x_spec, mesh)
        ln = cache["len"] if n is None else cache["len"][lo:lo + n]
        out = lm.forward(
            params, {"tokens": blk["tokens"]}, cfg, pcfg, mode="decode",
            cache={"layers": cache["layers"], "len": ln},
            paged={"table": blk["page_table"], "page_size": page_size},
            active=blk["active"], mesh=mesh, x_spec=x_spec)
        logits, new_sub = out[:2]
        if baxes:
            logits = mesh.all_gather(logits, baxes, 0)
        new_len = (cache["len"] + inputs["active"].int()).to(torch.int32)
        return (logits, {"layers": new_sub["layers"], "len": new_len}) \
            + tuple(out[4:])

    return serve_step


def _slot_block(cfg, pcfg, mesh, num_slots):
    """``lm.paged_slot_block`` on a mesh; ((), 0, None) without one (the
    step's slots are whatever the inputs hold)."""
    if mesh is None:
        return (), 0, None
    if num_slots is None:
        raise ValueError("a mesh needs num_slots, the paged engine's slots")
    return lm.paged_slot_block(cfg, pcfg, mesh, num_slots)


def _whole_spec(cfg, pcfg, mesh):
    """The activations' spec of a batch-1 forward: whole on every rank."""
    return _x_spec(None if mesh is None else (1, 1, cfg.d_model), pcfg, mesh)


def make_paged_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                            page_size: int, *, mesh=None,
                            num_slots: Optional[int] = None):
    """Chunked prefill into the paged cache: one request's next ``chunk``
    prompt tokens. Signature ``(params, tokens (chunk,), n_valid, slot,
    table_row (maxp,), cache) -> (last_logits (V,) f32, cache)``; a short
    final chunk pads and masks. All-attention stacks run ONE batch-1
    forward over the chunk; stacks with recurrent mixers a loop of
    single-token decode forwards (their state advances token by token
    mid-stream, so the chunk is a scheduling unit, not a compute one).
    On a ``mesh`` the forwards run whole on every rank, so every rank
    writes the chunk's rows alike; ``num_slots``: the engine's slots,
    whose recurrent state the ranks hold in blocks."""
    if not lm.recurrent_layers(cfg):
        return _make_paged_prefill_chunk(cfg, pcfg, page_size, mesh)
    return _make_paged_prefill_scan(cfg, pcfg, page_size, mesh, num_slots)


def _paged_chunk_forward(cfg: ModelConfig, pcfg: ParallelConfig,
                         page_size: int, mesh):
    """Shared body of the chunk-extension paged forward: final-norm hidden
    states at every chunk position, the cache with the slot's length
    advanced by ``n_valid``, and the router stats (None when telemetry
    is off). All-attention stacks only."""
    if lm.recurrent_layers(cfg):
        raise ValueError(
            "chunk-extension paged forward requires an all-attention "
            "stack (recurrent mixers advance token-wise)")
    lm.check_mesh(cfg, pcfg, mesh)
    x_spec = _whole_spec(cfg, pcfg, mesh)

    def fwd(params, tokens, n_valid: int, slot: int, table_row, cache):
        chunk = tokens.shape[0]
        # every layer is attention, so the layer cache is the shared
        # (batch-free) page pools — only the length is per-slot
        sub = {"layers": cache["layers"], "len": cache["len"][slot:slot + 1]}
        active = (torch.arange(chunk, device=tokens.device) < n_valid)[None]
        out = lm.forward(
            params, {"tokens": tokens[None]}, cfg, pcfg, mode="prefill",
            cache=sub, paged={"table": table_row[None], "page_size": page_size},
            active=active, return_hidden=True, mesh=mesh, x_spec=x_spec)
        hidden, sub = out[:2]
        new_len = cache["len"].clone()
        new_len[slot] = sub["len"][0]
        stats = out[4] if pcfg.collect_router_stats else None
        return hidden, {"layers": sub["layers"], "len": new_len}, stats

    return fwd, x_spec


def _make_paged_prefill_chunk(cfg: ModelConfig, pcfg: ParallelConfig,
                              page_size: int, mesh):
    fwd, x_spec = _paged_chunk_forward(cfg, pcfg, page_size, mesh)

    def prefill_step(params, tokens, n_valid: int, slot: int, table_row,
                     cache):
        hidden, new_cache, stats = fwd(params, tokens, n_valid, slot,
                                       table_row, cache)
        # last valid row only: the first-generated-token logits
        logits = lm.head_logits(params, hidden[:, n_valid - 1:n_valid], cfg,
                                pcfg, mesh, x_spec)
        if stats is not None:
            return logits.reshape(-1), new_cache, stats
        return logits.reshape(-1), new_cache

    return prefill_step


def make_paged_score_step(cfg: ModelConfig, pcfg: ParallelConfig,
                          page_size: int, *, mesh=None):
    """Multi-token scoring step for speculative verification: the
    chunk-extension paged forward of ``make_paged_prefill_step`` with
    logits at EVERY chunk position. Signature ``(params, tokens (k,),
    n_valid, slot, table_row (maxp,), cache) -> (logits (k, V) f32,
    cache)``: row ``i`` is the next-token distribution after
    ``tokens[:i+1]``, what a sequential decode would give having fed
    ``tokens[i]``. The slot's length advances by ``n_valid``; rows at and
    past ``n_valid`` write to the sink page and are to be ignored.
    All-attention stacks only (``_paged_chunk_forward`` raises). On a
    ``mesh``, whole on every rank as the prefill chunk."""
    if cfg.num_codebooks > 1:
        raise ValueError("score step does not support codebook heads")
    fwd, x_spec = _paged_chunk_forward(cfg, pcfg, page_size, mesh)

    def score_step(params, tokens, n_valid: int, slot: int, table_row,
                   cache):
        hidden, new_cache, stats = fwd(params, tokens, n_valid, slot,
                                       table_row, cache)
        logits = lm.score_logits(params, hidden, cfg, pcfg, mesh, x_spec)[0]
        if stats is not None:
            return logits, new_cache, stats
        return logits, new_cache

    return score_step


class _SlotRows:
    """One slot's rows of the recurrent state on a mesh whose ranks hold
    the slots in blocks of ``n`` over ``axes``: ``take`` gathers the row
    from its holder (a collective over ``axes``), ``put`` writes it where
    this rank holds the slot. Without a mesh the rows are local."""

    def __init__(self, mesh, axes, lo: int, n: Optional[int]):
        self.mesh, self.axes, self.lo, self.n = mesh, axes, lo, n

    def held(self, slot: int) -> bool:
        return self.n is None or self.lo <= slot < self.lo + self.n

    def take(self, t: torch.Tensor, slot: int) -> torch.Tensor:
        if not self.axes:
            return t[slot - self.lo:slot - self.lo + 1]
        i = slot % self.n
        rows = self.mesh.all_gather(t[i:i + 1], self.axes, 0)
        return rows[slot // self.n:slot // self.n + 1]

    def put(self, t: torch.Tensor, slot: int, row: torch.Tensor) -> None:
        if self.held(slot):
            t[slot - self.lo] = row[0]


def make_paged_handoff_step(cfg: ModelConfig, pcfg: Optional[ParallelConfig]
                            = None, *, mesh=None,
                            num_slots: Optional[int] = None):
    """Prefill-to-decode role handoff: move one finished-prefill sequence
    from slot ``src`` to slot ``dst``. The K/V pages stay in the shared
    pools and are reached through the host table row the scheduler moves,
    so no K/V byte moves; on the device the slot's ``len`` and its
    recurrent state rows (Mamba conv/ssm, xLSTM c/n/h/m) move, and
    ``src``'s are zeroed. ``handoff(cache, src, dst) -> cache``, in
    place. On a ``mesh`` a state row held by another rank than ``dst``'s
    crosses over (a gather over the slots' axes)."""
    recurrent = lm.recurrent_layers(cfg)
    rows = _SlotRows(mesh, *_slot_block(cfg, pcfg, mesh, num_slots))

    def handoff(cache, src: int, dst: int):
        for i in recurrent:
            for t in cache["layers"][i].values():
                row = rows.take(t, src)
                rows.put(t, dst, row)
                rows.put(t, src, torch.zeros_like(row))
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
    place; on a mesh every rank copies its own heads of the page."""
    recurrent = lm.recurrent_layers(cfg)

    def copy_page(cache, src: int, dst: int):
        for i, layer in enumerate(cache["layers"]):
            if i not in recurrent:
                for pool in layer.values():
                    pool[dst] = pool[src]
        return cache

    return copy_page


def _make_paged_prefill_scan(cfg: ModelConfig, pcfg: ParallelConfig,
                             page_size: int, mesh, num_slots):
    """The paged prefill of stacks with recurrent mixers: the slot's state
    rows taken out (on a mesh, gathered from the rank that holds them),
    one batch-1 decode forward a valid chunk token (whole on every rank),
    the rows written back where they are held; the last one's logits are
    returned. The JAX scan also runs the padding tokens past ``n_valid``,
    inactive (a sink-page write, state and length kept), which changes
    nothing; here they are skipped. With ``pcfg.collect_router_stats``
    the stats of the token forwards are summed (``obs.add_stats``) and
    returned third: the valid tokens' (JAX's sum also routes the inactive
    padding tokens of a short last chunk)."""
    serve_step = make_paged_serve_step(cfg, pcfg, page_size, mesh=mesh,
                                       num_slots=1)
    recurrent = lm.recurrent_layers(cfg)
    rows = _SlotRows(mesh, *_slot_block(cfg, pcfg, mesh, num_slots))

    def prefill_step(params, tokens, n_valid: int, slot: int, table_row,
                     cache):
        sub = {"layers": [
            {k: rows.take(t, slot) for k, t in layer.items()}
            if i in recurrent else layer
            for i, layer in enumerate(cache["layers"])],
            "len": cache["len"][slot:slot + 1]}
        inputs = {"page_table": table_row[None],
                  "active": torch.ones(1, dtype=torch.bool,
                                       device=tokens.device)}
        stats = (obs_device.zero_stats(
            cfg.moe.num_experts if cfg.moe is not None else 1,
            tokens.device) if pcfg.collect_router_stats else None)
        for t in range(n_valid):
            out = serve_step(
                params, {**inputs, "tokens": tokens[t].reshape(1, 1)}, sub)
            logits, sub = out[:2]
            if stats is not None:
                stats = obs_device.add_stats(stats, out[2])
        for i in recurrent:
            for k, t in cache["layers"][i].items():
                rows.put(t, slot, sub["layers"][i][k])
        new_len = cache["len"].clone()
        new_len[slot] = sub["len"][0]
        new_cache = {"layers": cache["layers"], "len": new_len}
        if stats is not None:
            return logits.reshape(-1), new_cache, stats
        return logits.reshape(-1), new_cache

    return prefill_step


def sharded_params(cfg: ModelConfig, pcfg: ParallelConfig, mesh, *,
                   generator: torch.Generator, device,
                   quant=None) -> tuple:
    """This rank's shards of a freshly drawn parameter tree and the tree's
    logical specs (``lm.param_specs``): every rank draws the same global
    tree from ``generator`` (padded by ``pcfg.hetero_plan``) and keeps its
    blocks, as ``parallel.sharding.shard`` cuts them."""
    full = lm.init_params(cfg, generator=generator, device=device,
                          quant=quant, plan=pcfg.hetero_plan)
    specs = lm.param_specs(cfg, pcfg)
    return shard_tree(full, specs, pcfg, mesh), specs


def sharded_opt_state(params, opt_cfg: adamw.OptimizerConfig) -> dict:
    """The AdamW state of a rank's parameter shards: the moments and f32
    masters inherit the shards, and the step count is replicated."""
    return adamw.init_opt_state(params, opt_cfg)


def wrap_step_with_faults(step_fn, site: str):
    """The chaos wrapper of a step callable (DESIGN.md §9):
    ``faults.inject(site)`` runs before every call (raising for the
    ``error``/``device_drop`` kinds, sleeping for ``delay``) and the step
    is entered only if no fault fires. The port's steps are eager, so it
    simply wraps the callable; the drivers wrap outside the
    ``PlanCache``, as the JAX package's do, so the hook is never cached
    with the step. With no installed plan it adds one attribute read a
    step."""
    from repro_torch.runtime import faults as faults_lib

    @functools.wraps(step_fn)
    def wrapped(*args, **kwargs):
        faults_lib.inject(site)
        return step_fn(*args, **kwargs)

    return wrapped
