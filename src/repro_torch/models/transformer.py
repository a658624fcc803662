"""Transformer building blocks (counterpart of ``repro.models.transformer``):
norms, GQA attention (full-sequence for training and dense prefill, over
the dense or the paged KV cache for serving), cross-attention to a
conditioning sequence, the dense FFN and the MoE FFN.

Parameters are plain dicts of tensors. The paged K/V pools and the dense
cache's decode rows are updated in place (the JAX version returns new
arrays): serving holds one cache and never needs the old one, so the port
saves the copy.

On a mesh (``Ctx.mesh``, a ``launch.mesh.Mesh``) the activations are
placed at ``Ctx.x_spec`` (``launch.inputs.activation_spec``: (dp, sp,
None)) and each rank holds its blocks of the weights (``*_LOGICAL``
placed by ``sharding.physical_spec``). The JAX package gets its layout
from GSPMD's sharding constraints; the port writes it out. Each norm,
attention and dense FFN runs as an island in the manner of ``shard_map``
(``island_in``/``island_out``, with ``moe_parallel``'s autograd
collectives): an input block held by several ranks sums its cotangent
over them on the way in, an output held by several divides it on the way
out, and every collective inside is paired with its adjoint, so autograd
gives the global function's gradients, as ``jax.grad`` does. A dense
weight's fsdp factor is gathered at use (its gradient reduce-scattered);
its tp factor stays: attention runs column-parallel q/k/v over this
rank's heads on the sequence gathered over "sp" and a row-parallel ``wo``
reduce-scattered back to (dp, sp, None) (all-reduced where the sequence
is not split), and the dense FFN splits its hidden width over "tp" the
same way (Megatron). Where the heads do not divide over "tp" (MQA, a
40-head stack on 16 ranks), attention keeps the queries' sequence chunk
and gathers K/V over the sequence instead (JAX's ``seq_parallel_attn``).
Cross-attention is the same island with K/V from the conditioning. On a
two-level mesh "tp" is the tuple ("node", "model"): the heads split over
its product, and these islands' collectives stay flat over the tuple (the
JAX package phases only the MoE island's). The MoE FFN is
``moe_parallel.moe_layer``'s own island.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import NEG_INF, paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.parallel.moe_parallel import (
    MoEStatic,
    _Enter,
    _Exit,
    _Gather,
    _Psum,
    _ScatterSum,
    _unmentioned,
    moe_layer,
)
from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    normal_init,
    physical_spec,
)
from repro_torch.quant.core import (dequantize_rows, quantize_blockwise,
                                    quantize_rows)


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
    cond: Optional[torch.Tensor] = None  # cross-attention memory (B, T, Dc)
    mesh: Optional[object] = None       # launch.mesh.Mesh, or None
    x_spec: tuple = (None, None, None)  # physical spec of (B, S, D)


#: Logical specs of the dense layers' weights (the JAX package's ``Param``
#: tags): the norms replicated, q/k/v column- and ``wo`` row-parallel.
NORM_LOGICAL = {"scale": (None,), "bias": (None,)}
ATTN_LOGICAL = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
                "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp"),
                "q_norm": (None,), "k_norm": (None,)}
DENSE_FFN_LOGICAL = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
                     "w_down": ("tp", "fsdp"), "w1": ("fsdp", "tp"),
                     "b1": ("tp",), "w2": ("tp", "fsdp"), "b2": (None,)}


# ---------------------------------------------------------------------------
# islands on a mesh
# ---------------------------------------------------------------------------

def island_in(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """An island input placed by the physical ``spec``: the identity, with
    its cotangent summed over the axes the spec leaves it replicated on
    (``shard_map``'s transpose)."""
    axes = _unmentioned(mesh, spec)
    return _Enter.apply(t, mesh, axes) if axes else t


def island_out(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """An island output placed by ``spec``: the identity, its cotangent
    divided by the number of ranks holding each block."""
    n = mesh.size(_unmentioned(mesh, spec))
    return _Exit.apply(t, n) if n > 1 else t


def weight_in(w: torch.Tensor, mesh, spec, logical, *,
              gather_tp: bool = False) -> torch.Tensor:
    """A dense weight's view inside an island: entered (``island_in``),
    its fsdp factor gathered (the backward reduce-scatters the gradient),
    and with ``gather_tp`` its tp factor as well."""
    w = island_in(w, mesh, spec)
    for dim, (lg, entry) in enumerate(zip(logical, spec)):
        axes = as_axes(entry)
        if axes and (lg == "fsdp" or (gather_tp and lg == "tp")):
            w = _Gather.apply(w, mesh, axes, dim)
    return w


def _leaf_spec(ctx: Ctx, shape, logical) -> tuple:
    return physical_spec(shape, logical, ctx.pcfg, ctx.mesh)


def seq_gather(x: torch.Tensor, mesh, seq_axes) -> torch.Tensor:
    return _Gather.apply(x, mesh, seq_axes, 1) if seq_axes else x


def seq_take(x: torch.Tensor, mesh, seq_axes) -> torch.Tensor:
    """This rank's sequence block of a whole-sequence value that every
    rank of ``seq_axes`` computed alike (its backward pads the cotangent
    with zeros: each rank carries its own block's share)."""
    if not seq_axes:
        return x
    sl = x.shape[1] // mesh.size(seq_axes)
    return x.narrow(1, mesh.index(seq_axes) * sl, sl)


def mesh_weights(p: dict, ctx: "Ctx", shapes: dict, table: dict, *,
                 gather_tp=()) -> tuple:
    """``weight_in`` of every leaf of ``p`` under its logical spec in
    ``table`` at its global shape in ``shapes``; the leaves named in
    ``gather_tp`` (or all, for True) also gather their tp factor.
    Returns (the weights, their physical specs)."""
    specs = {k: _leaf_spec(ctx, shapes[k], table[k]) for k in p}
    w = {k: weight_in(v, ctx.mesh, specs[k], table[k],
                      gather_tp=gather_tp is True
                      or (bool(gather_tp) and k in gather_tp))
         for k, v in p.items()}
    return w, specs


def row_parallel_out(h: torch.Tensor, w: torch.Tensor, rows, ctx: "Ctx",
                     seq_axes) -> torch.Tensor:
    """``h @ w`` for a whole-sequence ``h`` (B, S, K) that every rank of
    the TP group holds alike, with ``w`` this rank's block of rows over
    the axes ``rows`` (none: whole): this rank's K block of ``h`` times
    its rows, the partial sums reduce-scattered over the sequence back to
    x's placement (all-reduced where the sequence is not split); a whole
    ``w`` gives the product on each rank, which keeps its sequence
    block."""
    mesh = ctx.mesh
    if not rows:
        return seq_take(h @ w, mesh, seq_axes)
    kl = w.shape[0]
    y = h.narrow(-1, mesh.index(rows) * kl, kl) @ w
    if seq_axes and tuple(rows) != tuple(seq_axes):
        return seq_take(_Psum.apply(y, mesh, rows), mesh, seq_axes)
    return tp_reduce(y, mesh, seq_axes, rows)


def tp_reduce(y: torch.Tensor, mesh, seq_axes, tp) -> torch.Tensor:
    """Partial sums over "tp" placed back like x: reduce-scattered over
    the sequence where x's sequence is split ("sp" is "tp"), else
    all-reduced."""
    if seq_axes:
        return _ScatterSum.apply(y, mesh, seq_axes, 1)
    if as_axes(tp):
        return _Psum.apply(y, mesh, tp)
    return y


def block_norm(p: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``apply_norm`` of the residual stream; on a mesh, an island over
    x's block with the replicated scale (and bias)."""
    if ctx.mesh is None:
        return apply_norm(p, x, ctx.cfg)
    mesh = ctx.mesh
    x = island_in(x, mesh, ctx.x_spec)
    p = {k: island_in(v, mesh, NORM_LOGICAL[k]) for k, v in p.items()}
    return island_out(apply_norm(p, x, ctx.cfg), mesh, ctx.x_spec)


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
# dense FFN
# ---------------------------------------------------------------------------

def init_dense_ffn(cfg: ModelConfig, dtype, generator, device,
                   d_ff: Optional[int] = None,
                   glu: Optional[bool] = None) -> dict:
    """GLU (``w_gate``/``w_up``/``w_down``) or MLP (``w1``, ``b1``, ``w2``,
    ``b2``) weights of hidden width ``d_ff`` (default ``cfg.d_ff``)."""
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    if cfg.glu if glu is None else glu:
        return {
            "w_gate": normal_init((d, f), dtype, generator, device),
            "w_up": normal_init((d, f), dtype, generator, device),
            "w_down": normal_init((f, d), dtype, generator, device),
        }
    return {
        "w1": normal_init((d, f), dtype, generator, device),
        "b1": torch.zeros(f, dtype=torch.float32, device=device),
        "w2": normal_init((f, d), dtype, generator, device),
        "b2": torch.zeros(d, dtype=torch.float32, device=device),
    }


def apply_dense_ffn(p: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Dense FFN in x's dtype: ``(act(x Wg) * (x Wu)) Wd``, or
    ``act(x W1 + b1) W2 + b2`` with the biases cast to x's dtype. The JAX
    layer runs these products outside any Pallas kernel, so they stay
    ``torch.matmul`` here."""
    act = ACTIVATIONS[ctx.cfg.act]
    if ctx.mesh is not None:
        return _dense_ffn_mesh(p, x, ctx, act)
    if "w_gate" in p:
        return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w1"] + p["b1"].to(x.dtype)
    return act(h) @ p["w2"] + p["b2"].to(x.dtype)


def _dense_ffn_mesh(p: dict, x: torch.Tensor, ctx: Ctx, act) -> torch.Tensor:
    """The Megatron FFN on a mesh: the sequence gathered over "sp" once,
    the hidden width split over "tp", the down projection's partial sums
    reduce-scattered back to x's placement (all-reduced where the
    sequence is not split). A hidden width "tp" does not divide runs
    whole on x's own block. The MLP's output bias is added once, after
    the sum."""
    mesh, d = ctx.mesh, ctx.cfg.d_model
    f = (p["w_gate"] if "w_gate" in p else p["w1"]).shape[-1]
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d),
              "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
    specs = {k: _leaf_spec(ctx, shapes[k], DENSE_FFN_LOGICAL[k]) for k in p}
    w = {k: weight_in(v, mesh, specs[k], DENSE_FFN_LOGICAL[k])
         for k, v in p.items()}
    up = "w_gate" if "w_gate" in p else "w1"
    split = bool(as_axes(specs[up][1]))
    seq_axes = as_axes(ctx.x_spec[1]) if split else ()
    tp = ctx.pcfg.axes(mesh)["tp"] if split else None
    x = seq_gather(island_in(x, mesh, ctx.x_spec), mesh, seq_axes)
    if "w_gate" in w:
        y = (act(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]
        y = tp_reduce(y, mesh, seq_axes, tp)
    else:
        h = x @ w["w1"] + w["b1"].to(x.dtype)
        y = tp_reduce(act(h) @ w["w2"], mesh, seq_axes, tp) \
            + w["b2"].to(x.dtype)
    return island_out(y, mesh, ctx.x_spec)


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def init_moe_ffn(cfg: ModelConfig, dtype, generator, device,
                 quant: Optional[str] = None, plan=None) -> dict:
    """Router and expert weights: GLU (``w_gate``/``w_up``/``w_down``) or,
    where ``cfg.glu`` is False, MLP experts (``w1``, ``b1`` (E, F), ``w2``,
    ``b2`` (E, D), the biases f32 zeros, JAX's layout). ``quant`` ("int8"
    | "fp8"): each expert matrix is quantized (``quantize_blockwise``,
    expert by expert) as soon as it is drawn and its full-precision copy
    dropped, so at most one full-precision expert matrix exists; the
    draws are those of the unquantized init, in the same order.

    ``plan``: a ``core.hetero.HeteroPlan``. When its Eq. 2
    ``hidden_splits`` are uneven, the hidden dimension is padded to
    per-TP-rank tiles (``plan.padded_hidden_size()``, drawn at that width)
    and the padded columns hold exact zeros: they add exactly zero to the
    forward, get exactly zero gradient, and so stay zero in training. No
    plan, or an even one, leaves the init as it is, bit for bit."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.num_experts
    col = None  # (F',) validity mask over the padded hidden columns
    if plan is not None and getattr(plan, "hidden_splits", None) is not None:
        from repro_torch.core.hetero import hidden_mask

        if sum(plan.hidden_splits) != f:
            raise ValueError(
                f"hetero_plan.hidden_splits sum to {sum(plan.hidden_splits)}"
                f" but d_ff is {f}")
        if plan.hidden_padded():
            f = plan.padded_hidden_size()
            col = torch.from_numpy(hidden_mask(plan)).to(device)
    p = {"router": normal_init((d, e), torch.float32, generator, device)}
    # (name, shape, the hidden axis or None)
    leaves = ((("w_gate", (e, d, f), 2), ("w_up", (e, d, f), 2),
               ("w_down", (e, f, d), 1)) if cfg.glu else
              (("w1", (e, d, f), 2), ("b1", (e, f), 1), ("w2", (e, f, d), 1),
               ("b2", (e, d), None)))
    for name, shape, axis in leaves:
        if name.startswith("b"):
            p[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        p[name] = normal_init(shape, dtype, generator, device)
        if col is not None:
            view = [1, 1, 1]
            view[axis] = f
            p[name] = p[name] * col.reshape(view).to(dtype)
        if quant not in (None, "none"):
            p[name], p[f"{name}_scale"] = quantize_blockwise(p[name],
                                                             mode=quant)
    return p


def moe_static(cfg: ModelConfig, pcfg: ParallelConfig) -> MoEStatic:
    """The MoE layer's static hyperparameters; ``d_ff`` the experts'
    global hidden width, padded where ``pcfg.hetero_plan`` pads it."""
    m = cfg.moe
    f = m.d_ff
    plan = pcfg.hetero_plan
    if (plan is not None and getattr(plan, "hidden_splits", None) is not None
            and plan.hidden_padded()):
        f = plan.padded_hidden_size()
    return MoEStatic(num_experts=m.num_experts, top_k=m.top_k, act=cfg.act,
                     glu=cfg.glu, norm_topk=m.norm_topk,
                     softmax_after_topk=m.softmax_after_topk, d_ff=f)


def apply_moe_ffn(p: dict, x: torch.Tensor, ctx: Ctx,
                  layer_idx: Optional[int] = None,
                  gathered: Optional[tuple] = None):
    """Returns (y, aux_loss, z_loss), and the layer's router stats last
    when ``ctx.pcfg.collect_router_stats`` is set (``moe_layer``'s, passed
    up unchanged). x: (B, S, D), placed at ``ctx.x_spec`` on a mesh. ``layer_idx``: the period position, the key
    of the auto mode's per-layer plan. ``gathered``: (the expert weights
    gathered by the pipeline-shared cache, the collectives that gathered
    them: "fsdp" or "all"; ``parallel.cache.gather_ffn_params``); they
    replace the shards and the island skips those gathers."""
    pregathered = False
    if gathered is not None:
        weights, pregathered = gathered
        p = {**p, **weights}
    return moe_layer(x, p, moe_static(ctx.cfg, ctx.pcfg), ctx.pcfg,
                     ctx.mesh, x_spec=ctx.x_spec, layer_idx=layer_idx,
                     pregathered=pregathered)


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
    if ctx.mesh is not None:
        return _attention_mesh(p, x, ctx, layer_idx, cache)
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

    out = _paged_attend(q, k, v, ctx, cache, window)
    y = out.reshape(b, s, hq * hd) @ p["wo"]
    return y, cache


def _paged_attend(q, k, v, ctx: Ctx, cache: dict, window,
                  write_axes=()) -> torch.Tensor:
    """Paged serving attention over this rank's heads: q (B, S, Hq, hd),
    k and v (B, S, Hkv, hd) of the call's slots; the K/V rows are written
    into the pools of ``cache`` in place and the output (B, S, Hq, hd) is
    returned. ``write_axes``: the mesh axes the batch is split over; the
    rows, their page ids and offsets are gathered over them before the
    write, so every rank's pools receive every slot's rows."""
    cfg = ctx.cfg
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    page = int(ctx.paged["page_size"])
    table = ctx.paged["table"]                        # (B, maxp) int32
    maxp = table.shape[1]
    k_pool, v_pool = cache["k"], cache["v"]
    k_sc, v_sc = cache.get("k_scale"), cache.get("v_scale")
    rows = torch.arange(b, device=q.device)

    def write(phys, off, k_rows, v_rows):
        """K/V rows into the pools at (phys, off) (in place), gathered
        over ``write_axes`` first and quantized with their own scales
        where the pools are int8."""
        if write_axes:
            g = lambda t: ctx.mesh.all_gather(t, write_axes, 0)  # noqa: E731
            phys, off, k_rows, v_rows = g(phys), g(off), g(k_rows), g(v_rows)
        idx = (phys, off)
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
            active = torch.ones(b, dtype=torch.bool, device=q.device)
        length = ctx.cache_len
        logical = (length // page).clamp(max=maxp - 1).long()
        phys = torch.where(active, table[rows, logical], 0).long()
        off = (length % page).long()
        write(phys, off, k[:, 0], v[:, 0])
        lengths = (length + active.int()).to(torch.int32)
        return paged_attention(q, k_pool, v_pool, table, lengths,
                               k_scale=k_sc, v_scale=v_sc, window=window,
                               softcap=cfg.logit_softcap)
    active = ctx.decode_active                         # (B, S) valid rows
    if active is None:
        active = torch.ones((b, s), dtype=torch.bool, device=q.device)
    pos_abs = ctx.cache_len.long()[:, None] + torch.arange(
        s, device=q.device)[None]                      # (B, S)
    logical = (pos_abs // page).clamp(max=maxp - 1)
    phys = torch.where(active, table[rows[:, None], logical], 0).long()
    off = pos_abs % page
    write(phys.reshape(-1), off.reshape(-1), k.reshape(b * s, hkv, hd),
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
    kpos = torch.arange(s_all, device=q.device)[None, None]
    allowed = kpos <= pos_abs[:, :, None]              # causal, absolute
    if window is not None:
        allowed &= kpos > pos_abs[:, :, None] - window
    logits = torch.where(allowed[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd",
                       probs.to(v_view.dtype).float(), v_view.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def heads_shardable(cfg: ModelConfig, tp_size: int) -> bool:
    """Whether attention splits its heads over a TP group of ``tp_size``:
    both the query and the K/V head counts divide."""
    return cfg.num_heads % tp_size == 0 and cfg.num_kv_heads % tp_size == 0


def _attention_mesh(p: dict, x: torch.Tensor, ctx: Ctx, layer_idx: int,
                    cache):
    """``apply_attention`` on a mesh (train, dense and paged prefill and
    decode); x is this rank's block at ``ctx.x_spec``, the dense cache
    its block of slots (and of the K/V heads where they split), the paged
    cache every page with this rank's K/V heads (``lm.paged_cache_specs``):
    each written row is gathered over x's batch axes before the write
    (``_paged_attend``), and decode reads through ``paged_attention``.

    Heads shardable: x's sequence gathered over "sp" once, q/k/v over this
    rank's heads (the weights' tp column block), ``wo`` row-parallel, its
    partial sums reduce-scattered back over the sequence (all-reduced
    where the sequence is not split, decode included). Not shardable: the
    weights gathered whole; in train and prefill the queries keep this
    rank's sequence chunk and K/V are gathered over the sequence (one
    query chunk at its offset, ``attention.chunk_attention``); decode
    runs every head on every rank."""
    cfg, mesh = ctx.cfg, ctx.mesh
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    local = cfg.attn_kind(layer_idx) == "local" and cfg.window > 0
    window = cfg.window if local else None
    tp = ctx.pcfg.axes(mesh)["tp"]
    tp_size = mesh.size(tp)
    shard = heads_shardable(cfg, tp_size)
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d), "q_norm": (hd,), "k_norm": (hd,)}
    w = {k: weight_in(v, mesh, _leaf_spec(ctx, shapes[k], ATTN_LOGICAL[k]),
                      ATTN_LOGICAL[k], gather_tp=not shard)
         for k, v in p.items()}
    seq_axes = as_axes(ctx.x_spec[1])
    x = island_in(x, mesh, ctx.x_spec)
    positions = ctx.positions
    if shard:
        x = seq_gather(x, mesh, seq_axes)
        hq_l, hkv_l = hq // tp_size, hkv // tp_size
    else:
        hq_l, hkv_l = hq, hkv
        if ctx.mode != "decode" and seq_axes:
            positions = positions.narrow(
                1, mesh.index(seq_axes) * x.shape[1], x.shape[1])
    b, s, _ = x.shape
    q = (x @ w["wq"]).reshape(b, s, hq_l, hd)
    k = (x @ w["wk"]).reshape(b, s, hkv_l, hd)
    v = (x @ w["wv"]).reshape(b, s, hkv_l, hd)
    if cfg.qk_norm:
        q = _head_rms(q, w["q_norm"], cfg.norm_eps)
        k = _head_rms(k, w["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = attn_lib.rope(q, positions, cfg.rope_theta)
        k = attn_lib.rope(k, positions, cfg.rope_theta)

    if ctx.paged is not None:
        out = _paged_attend(q, k, v, ctx, cache, window, tuple(
            a for a in as_axes(ctx.x_spec[0]) if mesh.size(a) > 1))
        y = out.reshape(b, s, hq_l * hd) @ w["wo"]
    elif ctx.mode == "decode":
        y, cache = _dense_decode(q, k, v, ctx, cache, w["wo"])
    else:
        if shard or not seq_axes:
            out = attn_lib.chunked_attention(
                q, k, v, causal=True, window=window,
                prefix_len=cfg.prefix_len, softcap=cfg.logit_softcap,
                q_chunk=2048 if shard else s)
        else:
            k = seq_gather(k, mesh, seq_axes)
            v = seq_gather(v, mesh, seq_axes)
            out = attn_lib.chunk_attention(
                q, k, v, mesh.index(seq_axes), causal=True, window=window,
                prefix_len=cfg.prefix_len, softcap=cfg.logit_softcap)
        if cache is not None:
            cache = _dense_prefill_cache(k, v, cache)
        y = out.reshape(b, s, hq_l * hd) @ w["wo"]
    if shard:
        y = tp_reduce(y, mesh, seq_axes, tp)
    return island_out(y, mesh, ctx.x_spec), cache


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


# ---------------------------------------------------------------------------
# cross-attention (musicgen-large's T5 conditioning)
# ---------------------------------------------------------------------------

def init_cross_attention(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, hq, hd, dc = cfg.d_model, cfg.num_heads, cfg.hd, cfg.cross_d
    return {
        "wq": normal_init((d, hq * hd), dtype, generator, device),
        "wk": normal_init((dc, hq * hd), dtype, generator, device),
        "wv": normal_init((dc, hq * hd), dtype, generator, device),
        "wo": normal_init((hq * hd, d), dtype, generator, device),
    }


#: Logical specs of the cross-attention weights (the JAX package's).
XATTN_LOGICAL = {"wq": ("fsdp", "tp"), "wk": (None, "tp"),
                 "wv": (None, "tp"), "wo": ("tp", "fsdp")}


def cross_attention_shapes(cfg: ModelConfig) -> dict:
    d, hq, hd, dc = cfg.d_model, cfg.num_heads, cfg.hd, cfg.cross_d
    return {"wq": (d, hq * hd), "wk": (dc, hq * hd), "wv": (dc, hq * hd),
            "wo": (hq * hd, d)}


def apply_cross_attention(p: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Every query row attends to every row of ``ctx.cond`` (B, T, Dc): no
    RoPE, no mask, f32 logits, the softmax cast to x's dtype. K and V are
    computed from ``cond`` at every call (decode included): nothing is
    cached, as in the JAX layer. Plain ``torch.matmul``, as the JAX layer
    is plain einsums.

    On a mesh (``ctx.cond`` this rank's batch block, whole), an island as
    self-attention's: where the heads split over "tp", the sequence
    gathered over "sp", q/k/v over this rank's heads, ``wo`` row-parallel
    and reduce-scattered back; else the weights gathered whole and the
    rank's own query rows attending (no mask needs the others)."""
    cfg = ctx.cfg
    hq, hd = cfg.num_heads, cfg.hd
    mesh = ctx.mesh
    shard = False
    if mesh is not None:
        tp = ctx.pcfg.axes(mesh)["tp"]
        shard = hq % mesh.size(tp) == 0
        p, _ = mesh_weights(p, ctx, cross_attention_shapes(cfg),
                            XATTN_LOGICAL, gather_tp=not shard)
        seq_axes = as_axes(ctx.x_spec[1]) if shard else ()
        x = seq_gather(island_in(x, mesh, ctx.x_spec), mesh, seq_axes)
        hq //= mesh.size(tp) if shard else 1
    b, s, _ = x.shape
    cond = ctx.cond.to(x.dtype)
    t = cond.shape[1]
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (cond @ p["wk"]).reshape(b, t, hq, hd)
    v = (cond @ p["wv"]).reshape(b, t, hq, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * hd ** -0.5
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    y = out.reshape(b, s, hq * hd) @ p["wo"]
    if mesh is None:
        return y
    if shard:
        y = tp_reduce(y, mesh, seq_axes, tp)
    return island_out(y, mesh, ctx.x_spec)
