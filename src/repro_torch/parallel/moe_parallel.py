"""MoE layer execution, on one device or on a mesh of ranks (counterpart of
``repro.parallel.moe_parallel``).

Without a mesh ``moe_layer`` flattens (B, S, D) to tokens and runs the
local body of ``hexa_moe_island``: route, expert-sorted re-index, fused
expert FFN (GLU, or 2-MLP with biases), combine. The layer's parameters
are a dict: 'router' plus 'w_gate'/'w_up'/'w_down' (``MoEStatic.glu``) or
'w1'/'b1'/'w2'/'b2', and for true-quantized experts (int8/fp8 payloads)
their '<name>_scale' block scales, which need whole expert weights on the
device. With ``ParallelConfig.quant`` the island fake-quantizes the expert
weights (quantization-aware training).

With a mesh (``launch.mesh.Mesh``) each rank passes its own shards: x as
``x_spec`` places it, each parameter as ``MOE_PARAM_LOGICAL`` (or
``EP_PARAM_LOGICAL``) places it under ``cfg.mode``
(``sharding.physical_spec``; ``convert.shard_params`` cuts them). The
islands are the paper's §4.3 configurations:

  model-centric: expert hidden dim sharded over "model"; tokens gathered
    over "model" when ``x_spec[1]`` shards them; partial outputs summed
    (``ag_ar``: all-reduce, each rank keeping its token chunk; ``ag_rs``:
    reduce-scatter). No weight moves.
  data-centric: expert weights sharded over every axis and gathered at
    use; tokens never move.
  hybrid: the fsdp gather over ("pod", "data") + TP over "model".
  auto: the hybrid placement; each layer picks data- or model-centric
    dispatch from ``parallel.autotune``'s roofline.
  ep: the expert-parallel baseline: experts sharded over "model", tokens
    exchanged by all-to-all into a capacity buffer.

Autograd mirrors ``shard_map``'s transpose, so the gradients are those of
the global function, as ``jax.grad`` gives them. Inside the island each
collective's backward is its adjoint (all-gather <-> reduce-scatter,
all-reduce <-> all-reduce, all-to-all <-> all-to-all). At the boundary,
an input replicated over some axes has its cotangent summed over them,
and an output replicated over some axes has its cotangent divided by
their size. So a caller treats the layer as one global function: a value
held by several ranks carries its whole cotangent on each of them (the
loss of each rank counts a replicated term whole), and the returned
parameter gradients are the global gradient's blocks. The all-reduce of
partial outputs then acts as the identity in the backward, and the
router's gradient is summed over every rank inside the layer.

``cfg.cache_policy`` decides what the training backward keeps of the
gathered expert weights (``torch.utils.checkpoint``; see
``sharding.ParallelConfig``). Not ported, and refused: the hierarchical
schedule of a mesh with a "node" axis, ``overlap_dispatch`` and
``collect_router_stats`` (ROADMAP.md A.5, A.6).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import ACTIVATIONS
from repro_torch.core import baselines, espec
from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    physical_spec,
    spec_axes,
)
from repro_torch.quant.core import EXPERT_WEIGHT_KEYS, fake_quant


class MoEStatic(NamedTuple):
    """Static MoE layer hyperparameters. ``d_ff``: the experts' global
    hidden width (padded, under a plan that pads it); a mesh needs it to
    place the shards, which do not show it."""
    num_experts: int
    top_k: int
    act: str = "silu"
    glu: bool = True
    norm_topk: bool = True
    softmax_after_topk: bool = False
    d_ff: Optional[int] = None


# ---------------------------------------------------------------------------
# collectives with autograd
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.reduce_scatter(g, axes, dim), None, None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.all_gather(g, axes, dim), None, None, None


class _Psum(torch.autograd.Function):
    """All-reduce (sum); backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


class _AllToAll(torch.autograd.Function):
    """All-to-all over dim 0's blocks; its own adjoint."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_to_all(g, axes), None, None


class _Enter(torch.autograd.Function):
    """An island input replicated over ``axes``: identity; backward sums
    the cotangent over them (``shard_map``'s transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g, axes), None, None


class _Exit(torch.autograd.Function):
    """An island output replicated over ``n`` ranks: identity; backward
    divides the cotangent by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Reshard(torch.autograd.Function):
    """A global-level all-gather (a resharding, as GSPMD's constraint):
    the gathered value is one replicated global tensor, so the backward
    keeps this rank's block of its cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim, x.shape[dim])
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, n = ctx.args
        return (g.narrow(dim, mesh.index(axes) * n, n).contiguous(),
                None, None, None)


def _ag(x, mesh, axes, dim):
    """Tiled all-gather over ``axes`` (none: x itself)."""
    if x is None or not axes:
        return x
    return _Gather.apply(x, mesh, axes, dim)


def _unmentioned(mesh, spec) -> tuple:
    named = set(spec_axes(spec))
    return tuple(a for a in mesh.axis_names if a not in named)


# ---------------------------------------------------------------------------
# islands
# ---------------------------------------------------------------------------

def _mask_rank0(b, mesh, tp_axis):
    """Keep a partial-sum bias on TP rank 0 only (avoids a k_tp-fold
    bias). A multiply, not a branch: every rank runs the same graph."""
    if b is None or tp_axis is None:
        return b
    keep = 1.0 if mesh.coord(tp_axis) == 0 else 0.0
    return b * keep


def _island_weights(p: dict, ms: MoEStatic, cfg: ParallelConfig, mesh, *,
                    layer_mode, pregathered) -> dict:
    """The weights the island computes with: each expert weight gathered
    over its fsdp factor (unless ``pregathered``) and, for data-centric
    dispatch, its TP factor; fake-quantized under ``cfg.quant``; the
    MLP's output bias kept on TP rank 0 only when the output is a sum
    over TP."""
    quantized = "w_gate_scale" in p or "w1_scale" in p
    if mesh is None:
        fsdp, tp = (), None
    else:
        axes = cfg.axes(mesh)
        fsdp, tp = (() if pregathered else axes["fsdp"]), axes["tp"]
        if quantized and (fsdp or tp is not None):
            raise NotImplementedError(
                "true-quantized expert weights require ungathered "
                "whole-expert layouts (no fsdp/tp over expert weights); use "
                "cfg.quant (QAT fake-quant) on sharded meshes")
    dc = layer_mode == "data_centric" and tp is not None
    tp_w = tp if dc else None

    def fq(w):
        if w is None or quantized or cfg.quant == "none":
            return w
        return fake_quant(w, cfg.quant, cfg.quant_tile)

    out = dict(p)
    if ms.glu:
        for name, fdim, tdim in (("w_gate", 1, 2), ("w_up", 1, 2),
                                 ("w_down", 2, 1)):
            out[name] = fq(_ag(_ag(p[name], mesh, fsdp, fdim), mesh, tp_w,
                               tdim))
    else:
        out["w1"] = fq(_ag(_ag(p["w1"], mesh, fsdp, 1), mesh, tp_w, 2))
        out["w2"] = fq(_ag(_ag(p["w2"], mesh, fsdp, 2), mesh, tp_w, 1))
        out["b1"] = _ag(p.get("b1"), mesh, tp_w, 1)
        b2 = _ag(p.get("b2"), mesh, fsdp, 1)
        out["b2"] = b2 if dc else _mask_rank0(b2, mesh, tp)
    return out


def hexa_moe_island(x: torch.Tensor, p: dict, ms: MoEStatic,
                    cfg: ParallelConfig, mesh=None, *,
                    tokens_sharded_tp: bool = False,
                    layer_mode: Optional[str] = None, pregathered=False,
                    token_valid: Optional[torch.Tensor] = None,
                    weights: Optional[dict] = None):
    """Local tokens x (N_l, D) -> (y, aux_loss, z_loss).

    ``tokens_sharded_tp``: whether the token dim is sharded over TP (and
    gathered here) or replicated. ``layer_mode``: "data_centric" gathers
    the weights' TP factor and keeps tokens and output local;
    "model_centric"/None keeps the TP split and moves tokens.
    ``pregathered``: the fsdp factor was gathered outside
    (``parallel.cache.gather_ffn_params``). ``token_valid``: the (N_l,)
    Eq. 1 tail mask; masked rows get gate 0, exactly zero output and
    gradient, and no part in the aux losses. ``weights``: the island's
    weights already gathered (``_island_weights``), for the "janus"
    cache policy. Scale leaves of quantized experts go with their
    payloads to ``espec``; without them ``cfg.quant`` fake-quantizes."""
    tp = None if mesh is None else cfg.axes(mesh)["tp"]
    dc = layer_mode == "data_centric" and tp is not None
    gather_tokens = tp is not None and tokens_sharded_tp and not dc
    if gather_tokens:
        x = _ag(x, mesh, tp, 0)
        if token_valid is not None:
            token_valid = mesh.all_gather(token_valid.to(torch.int32), tp,
                                          0).bool()
    if weights is None:
        weights = _island_weights(p, ms, cfg, mesh, layer_mode=layer_mode,
                                  pregathered=pregathered)
    w = weights
    # through espec's names, as espec.hexa_moe_ffn routes: a caller that
    # wraps espec.route or espec.build_reindex sees this layer's calls
    r = espec.route(x, w["router"], ms.top_k, norm_topk=ms.norm_topk,
                    softmax_after_topk=ms.softmax_after_topk,
                    valid_mask=token_valid)
    ri = espec.build_reindex(r.expert_idx, r.gates, ms.num_experts, cfg.blk)
    if ms.glu:
        scales = ((w["w_gate_scale"], w["w_up_scale"], w["w_down_scale"])
                  if "w_gate_scale" in w else None)
        y = espec.moe_glu(x, ri, w["w_gate"], w["w_up"], w["w_down"],
                          scales=scales, act=ms.act)
    else:
        scales = ((w["w1_scale"], w["w2_scale"]) if "w1_scale" in w
                  else None)
        y = espec.moe_mlp(x, ri, w["w1"], w.get("b1"), w["w2"], w.get("b2"),
                          scales=scales, act=ms.act)

    if tp is not None and not dc:
        # partial products over the TP-sharded hidden dim
        if gather_tokens and cfg.collective_schedule == "ag_rs":
            y = _ScatterSum.apply(y, mesh, tp, 0)
        elif gather_tokens:
            # paper-faithful ag_ar: all-reduce, then keep own token chunk
            y = _Psum.apply(y, mesh, tp)
            nl = y.shape[0] // mesh.size(tp)
            y = y.narrow(0, mesh.index(tp) * nl, nl)
        else:
            y = _Psum.apply(y, mesh, tp)
    return y, r.aux_loss, r.z_loss


def ep_moe_island(x: torch.Tensor, p: dict, ms: MoEStatic,
                  cfg: ParallelConfig, mesh, *, tokens_sharded_tp: bool,
                  token_valid: Optional[torch.Tensor] = None):
    """Expert-parallel baseline: experts sharded over "model", tokens
    travel by all-to-all into a capacity buffer (padding and drops), the
    GShard/Tutel execution the paper replaces. Masked rows (``token_valid``)
    get gate 0, so their output and weight gradients are exactly zero;
    they may still take capacity slots."""
    del tokens_sharded_tp  # each rank routes its own rows either way
    if "w_gate_scale" in p or "w1_scale" in p:
        raise NotImplementedError(
            "the EP baseline does not support quantized expert weights")
    tp = cfg.axes(mesh)["tp"]
    ep = mesh.size(tp) if tp else 1
    e, k = ms.num_experts, ms.top_k
    if e % ep:
        raise ValueError(f"the EP baseline needs num_experts {e} % ep {ep} "
                         f"== 0")
    r = espec.route(x, p["router"], k, norm_topk=ms.norm_topk,
                    softmax_after_topk=ms.softmax_after_topk,
                    valid_mask=token_valid)
    n, d = x.shape
    capacity = max(int((n * k / e) * cfg.capacity_factor), 1)
    rank, _ = baselines._dispatch_ranks(r.expert_idx, e)
    keep = rank < capacity
    slot = r.expert_idx.long() * capacity + rank.long()
    slot = torch.where(keep, slot, e * capacity)       # dropped: extra row
    src = x[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = x.new_zeros(e * capacity + 1, d).index_copy(0, slot.reshape(-1),
                                                      src)
    buf = buf[:e * capacity].reshape(e, capacity, d)
    if tp is not None and ep > 1:
        # (E, C, D): device m ends up with its E/ep experts' rows from
        # every peer; the return path mirrors it.
        buf = _AllToAll.apply(buf.reshape(ep, e // ep, capacity, d),
                              mesh, tp)
        buf = buf.transpose(0, 1).reshape(e // ep, ep * capacity, d)
    if ms.glu:
        h = torch.nn.functional.silu(torch.einsum(
            "ecd,edf->ecf", buf, p["w_gate"].to(buf.dtype)))
        h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(buf.dtype))
        out = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(buf.dtype))
    else:
        h = torch.einsum("ecd,edf->ecf", buf, p["w1"].to(buf.dtype))
        if p.get("b1") is not None:
            h = h + p["b1"][:, None].to(buf.dtype)
        h = ACTIVATIONS[ms.act](h)
        out = torch.einsum("ecf,efd->ecd", h, p["w2"].to(buf.dtype))
        if p.get("b2") is not None:
            out = out + p["b2"][:, None].to(buf.dtype)
    if tp is not None and ep > 1:
        out = out.reshape(e // ep, ep, capacity, d).transpose(0, 1)
        out = _AllToAll.apply(out.contiguous(), mesh, tp)
        out = out.reshape(e, capacity, d)
    y_flat = out.reshape(e * capacity, d)
    got = y_flat[torch.clamp(slot, max=e * capacity - 1).reshape(-1)]
    gates = (r.gates * keep.to(r.gates.dtype))[..., None].to(x.dtype)
    y = torch.sum(got.reshape(n, k, d) * gates, dim=1)
    return y, r.aux_loss, r.z_loss


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _auto_layer_mode(ms: MoEStatic, d: int, cfg: ParallelConfig, mesh,
                     tokens: int, layer_idx: Optional[int]) -> str:
    """The per-layer dispatch of ``cfg.mode == "auto"`` from shapes
    (paper Fig. 10 roofline; ``parallel.autotune``)."""
    from repro_torch.parallel import autotune

    if mesh is not None:
        dp = mesh.size(cfg.axes(mesh)["dp"])
        tokens = max(tokens // max(dp, 1), 1)  # workload per TP group
    return autotune.resolve_layer_mode(
        tokens, d=d, f=ms.d_ff, e=ms.num_experts, k=ms.top_k, cfg=cfg,
        mesh=mesh, layer_idx=layer_idx)


def _hetero_mask_counts(plan, x_spec, mesh, b: int):
    """The Eq. 1 token mask: ``(token_counts, batch_axes)`` when the
    plan's data split is uneven at this sharding, or None (no plan, no
    mesh, or a uniform split that fills every shard: no masking at all,
    the uniform path's operations)."""
    if plan is None or getattr(plan, "token_counts", None) is None:
        return None
    if mesh is None:
        return None
    baxes = as_axes(x_spec[0])
    extent = mesh.size(baxes)
    counts = tuple(int(c) for c in plan.token_counts)
    if len(counts) != extent:
        raise ValueError(
            f"hetero_plan.token_counts has {len(counts)} entries but the "
            f"batch dim is sharded over {extent} devices")
    local_b = b // extent
    if max(counts) > local_b:
        raise ValueError(
            f"hetero_plan assigns {max(counts)} batch rows to a device but "
            f"the padded shard holds only {local_b} (global batch {b})")
    if all(c == local_b for c in counts):
        return None
    return counts, baxes


def _check_mesh(cfg: ParallelConfig, mesh, ms: MoEStatic) -> None:
    if "node" in mesh.axis_names:
        raise NotImplementedError(
            "the hierarchical two-level schedule (a mesh with a 'node' "
            "axis) is not ported (ROADMAP.md A.5)")
    if cfg.overlap_dispatch:
        raise NotImplementedError(
            "overlap_dispatch is not ported (ROADMAP.md A.5)")
    if cfg.collect_router_stats:
        raise NotImplementedError(
            "collect_router_stats is not ported (ROADMAP.md A.6)")
    if ms.d_ff is None:
        raise ValueError("a mesh needs MoEStatic.d_ff, the experts' global "
                         "hidden width")


def moe_layer(x: torch.Tensor, p: dict, ms: MoEStatic, cfg: ParallelConfig,
              mesh=None, *, x_spec=None, layer_idx: Optional[int] = None,
              pregathered: bool = False):
    """MoE FFN over a (B, S, D) activation -> (y, aux_loss, z_loss).

    Without a mesh: the whole layer on this device. With one: ``x`` is
    this rank's block of the global (B, S, D) activation as ``x_spec`` (a
    3-entry physical spec) places it, ``p`` its parameter shards, and y
    comes back placed like x; aux and z are the global means (weighted by
    valid rows under an uneven ``cfg.hetero_plan``). ``layer_idx`` feeds
    the auto-mode plan lookup; ``pregathered``: the weights' fsdp factor
    was gathered outside (``parallel.cache.gather_ffn_params``)."""
    b, s, d = x.shape
    if mesh is None:
        # one device: no group to move tokens or weights across, so every
        # mode (and auto's choice) runs the same local body
        y, aux, z = hexa_moe_island(x.reshape(b * s, d), p, ms, cfg)
        return y.reshape(b, s, d), aux, z

    _check_mesh(cfg, mesh, ms)
    x_spec = tuple(x_spec) + (None,) * (3 - len(x_spec))
    for entry in x_spec:
        for a in as_axes(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"x_spec {x_spec} names axis {a!r}, which "
                                 f"the mesh {mesh.axis_names} lacks")
    gb = b * mesh.size(as_axes(x_spec[0]))
    gs = s * mesh.size(as_axes(x_spec[1]))
    ep = cfg.mode == "ep"
    layer_mode = None
    if not ep and cfg.mode == "auto":
        layer_mode = _auto_layer_mode(ms, d, cfg, mesh, gb * gs, layer_idx)
    mask_counts = _hetero_mask_counts(cfg.hetero_plan, x_spec, mesh, gb)
    tokens_tp = x_spec[1] is not None
    world = tuple(mesh.axis_names)

    # boundary: inputs replicated over some axes sum their cotangent there
    specs = _param_specs(ms, d, cfg, mesh, pregathered=pregathered)
    x = _Enter.apply(x, mesh, _unmentioned(mesh, x_spec))
    pl = {name: (None if v is None else
                 _Enter.apply(v, mesh, _unmentioned(mesh, specs[name])))
          for name, v in p.items()}

    tv = bv = None
    if mask_counts is not None:
        counts, baxes = mask_counts
        # row r of the flat (b*s) shard is batch element r // s; elements
        # past this rank's Eq. 1 share are the masked tail
        bv = counts[mesh.index(baxes)]
        tv = (torch.arange(b * s, device=x.device) // s) < bv

    xf = x.reshape(b * s, d)
    if ep:
        y, aux, z = ep_moe_island(xf, pl, ms, cfg, mesh,
                                  tokens_sharded_tp=tokens_tp,
                                  token_valid=tv)
    else:
        island = functools.partial(
            hexa_moe_island, ms=ms, cfg=cfg, mesh=mesh,
            tokens_sharded_tp=tokens_tp, layer_mode=layer_mode,
            pregathered=pregathered, token_valid=tv)
        names = [k for k, v in pl.items() if v is not None]
        policy = cfg.cache_policy if torch.is_grad_enabled() else "none"
        if policy == "shared_cache":
            # gathers and compute recomputed in the backward: no gathered
            # weight is saved for it
            def run(xf, *leaves):
                return island(xf, dict(zip(names, leaves)))

            y, aux, z = checkpoint(run, xf, *(pl[k] for k in names),
                                   use_reentrant=False)
        elif policy == "janus":
            # the gathered weights are saved; the compute is recomputed
            w = _island_weights(pl, ms, cfg, mesh, layer_mode=layer_mode,
                                pregathered=pregathered)
            wnames = [k for k, v in w.items() if v is not None]

            def run(xf, *leaves):
                return island(xf, pl, weights=dict(zip(wnames, leaves)))

            y, aux, z = checkpoint(run, xf, *(w[k] for k in wnames),
                                   use_reentrant=False)
        else:
            y, aux, z = island(xf, pl)

    n = mesh.size(world)
    if bv is None:
        aux = _Psum.apply(aux, mesh, world) / n
        z = _Psum.apply(z, mesh, world) / n
    else:
        # each rank's aux is a mean over ITS valid rows: weight by them,
        # so the result is the mean over every valid token
        wgt = torch.tensor(float(bv * s), dtype=torch.float32,
                           device=x.device)
        wsum = mesh.all_reduce(wgt, world)
        aux = _Psum.apply(aux * wgt, mesh, world) / wsum
        z = _Psum.apply(z * wgt, mesh, world) / wsum
    y = _Exit.apply(y.reshape(b, s, d),
                    mesh.size(_unmentioned(mesh, x_spec)))
    return y, _Exit.apply(aux, n), _Exit.apply(z, n)


def _param_specs(ms: MoEStatic, d: int, cfg: ParallelConfig, mesh, *,
                 pregathered: bool = False) -> dict:
    """Physical specs of the MoE leaves at their global shapes (E, D, F),
    from the same tables the init and gather paths use. ``pregathered``:
    the weights arrive with their fsdp factor gathered."""
    from repro_torch.parallel.cache import _drop_axes

    table = EP_PARAM_LOGICAL if cfg.mode == "ep" else MOE_PARAM_LOGICAL
    shapes = moe_param_shapes(ms.num_experts, d, ms.d_ff)
    out = {}
    for name, logical in table.items():
        if pregathered and name != "router":
            logical = _drop_axes(logical, ("fsdp",))
        shape = shapes.get(name)
        out[name] = (tuple(None for _ in logical) if shape is None
                     else physical_spec(shape, logical, cfg, mesh))
    return out


def moe_param_shapes(e: int, d: int, f: int) -> dict:
    """Global shapes of the MoE leaves (the scale leaves stay whole)."""
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d), "w1": (e, d, f), "b1": (e, f),
            "w2": (e, f, d), "b2": (e, d)}


#: Block-wise scale leaves of quantized expert weights stay replicated:
#: the quantized path needs whole-expert layouts anyway.
_SCALE_LOGICAL = {f"{k}_scale": (None, None, None) for k in EXPERT_WEIGHT_KEYS}

MOE_PARAM_LOGICAL = {
    "router": (None, None),
    "w_gate": (None, "fsdp", "tp"),
    "w_up": (None, "fsdp", "tp"),
    "w_down": (None, "tp", "fsdp"),
    "w1": (None, "fsdp", "tp"),
    "b1": (None, "tp"),
    "w2": (None, "tp", "fsdp"),
    "b2": (None, "fsdp"),
    **_SCALE_LOGICAL,
}

EP_PARAM_LOGICAL = {
    "router": (None, None),
    "w_gate": ("tp", None, None),
    "w_up": ("tp", None, None),
    "w_down": ("tp", None, None),
    "w1": ("tp", None, None),
    "b1": ("tp", None),
    "w2": ("tp", None, None),
    "b2": ("tp", None),
    **_SCALE_LOGICAL,
}
