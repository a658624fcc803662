"""Parallel configuration, logical-to-mesh placement and initializers
(counterpart of ``repro.parallel.sharding``).

Logical axis names used by the parameter specs:

  "fsdp"  — ZeRO-3 style parameter sharding, gathered at use. Maps to the
            ("pod", "data") mesh axes (the paper's *data-centric* gathering).
  "tp"    — tensor parallelism, kept sharded through compute. Maps to
            "model" (the paper's *model-centric* hidden-dim split).
  "dp"    — batch data parallelism: ("pod", "data").
  "sp"    — sequence parallelism for activations: "model".

``ParallelConfig.mode`` selects the mapping (``ParallelConfig.axes``).
Where the JAX package hands a logical spec to GSPMD, the port places the
tensor itself: ``resolve_spec`` and ``divisible_spec`` turn a logical
spec into a physical one (an axis that does not divide a dimension leaves
it replicated, as GSPMD does), ``shard`` cuts this rank's block of a full
tensor and ``unshard`` gathers the blocks back. A physical spec is a
tuple with one entry a dimension: None, a mesh axis name, or a tuple of
names (major first, in mesh order); the block index along a dimension is
the rank's linear index over those axes (``launch.mesh.Mesh.index``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How logical axes map onto the mesh, and the knobs of the MoE layer.

    blk: rows per single-expert block of the expert-sorted layout.
    remat: "block" recomputes each block's forward in the training
    backward (``torch.utils.checkpoint``; only the block inputs are
    saved), "none" saves every activation. Serving forwards ignore it.
    capacity_factor: the capacity of ``moe_impl="tutel"``
    (``core.baselines.dispatch_combine_moe``) and of the "ep" mode's
    all-to-all buffer; the Hexa-MoE path has no capacity and ignores it.
    quant: "none" | "int8" | "fp8": quantization-aware training, each
    expert weight passed through ``quant.core.fake_quant`` inside the MoE
    island (straight-through grads; routers and biases untouched). Skipped
    where the params already hold 8-bit payloads with '<name>_scale'
    leaves, which go to the kernels' 8-bit branches instead.
    quant_tile: the block size of those per-(expert, tile) scales.

    The mesh fields (read only when a ``launch.mesh.Mesh`` is given):

    mode:
      "hybrid"        — fsdp -> (pod, data), tp -> model
      "model_centric" — fsdp -> (),          tp -> model  (paper §4.3 TP)
      "data_centric"  — fsdp -> ALL axes,    tp -> ()     (paper §4.3 gather)
      "auto"          — hybrid placement; each MoE layer picks its
                        data-/model-centric dispatch from the roofline
                        (``parallel.autotune``, paper Fig. 10)
      "ep"            — expert parallelism baseline (all-to-all)
    collective_schedule:
      "ag_ar" — paper-faithful: tokens replicated in TP, outputs
                all-reduced (each rank then keeps its own token chunk).
      "ag_rs" — all-gather in, reduce-scatter out.
    cache_policy (the pipeline-shared cache in the training backward):
      "shared_cache" — the gathered expert weights are not saved for the
                       backward: it gathers them again (and recomputes the
                       island).
      "janus"        — the gathered weights are kept for the backward; the
                       island's compute is recomputed.
      "none"         — nothing is recomputed.
    forced_layer_mode, layer_mode_plan, device_latencies: the "auto"
      chooser's overrides and heterogeneous proxy latencies
      (``autotune.resolve_layer_mode``).
    hetero_plan: a ``core.hetero.HeteroPlan``; its uneven Eq. 1
      ``token_counts`` mask each batch-group member's tail rows in the MoE
      islands (zero output, zero gradient, left out of the aux losses).
    topology: an ``autotune.Topology`` pricing the chooser's collectives
      per interconnect level. The hierarchical schedule it switches on for
      a mesh with a "node" axis is not ported (ROADMAP.md A.5).
    overlap_dispatch, collect_router_stats: not ported (ROADMAP.md A.5,
      A.6); True raises in ``moe_parallel.moe_layer``.

    Every default is the JAX package's. Its ``scan_layers``, ``impl``
    and ``fused_ffn`` have no counterpart: the port's layer loop is always
    unrolled, and its MoE islands always run the fused expert FFN
    (``kernels.esffn``). Its ``cache_layers`` comes with the LM's mesh
    forward, which reads it (ROADMAP.md A.5)."""
    blk: int = 128
    remat: str = "block"          # none | block
    capacity_factor: float = 1.25
    quant: str = "none"           # expert-weight QAT: none | int8 | fp8
    quant_tile: int = 128
    mode: str = "hybrid"
    collective_schedule: str = "ag_rs"
    cache_policy: str = "shared_cache"
    forced_layer_mode: Optional[str] = None
    layer_mode_plan: Optional[Tuple[Optional[str], ...]] = None
    device_latencies: Optional[Tuple[float, ...]] = None
    hetero_plan: Optional[Any] = None  # core.hetero.HeteroPlan
    topology: Optional[Any] = None     # autotune.Topology
    overlap_dispatch: bool = False
    collect_router_stats: bool = False

    def __post_init__(self):
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat {self.remat!r}: none | block")
        if self.quant not in ("none", "int8", "fp8"):
            raise ValueError(f"quant {self.quant!r}: none | int8 | fp8")
        if self.quant_tile < 1:
            raise ValueError(f"quant_tile {self.quant_tile} < 1")
        if self.mode not in ("hybrid", "model_centric", "data_centric",
                             "auto", "ep"):
            raise ValueError(f"mode {self.mode!r}: hybrid | model_centric | "
                             f"data_centric | auto | ep")
        if self.collective_schedule not in ("ag_ar", "ag_rs"):
            raise ValueError(f"collective_schedule "
                             f"{self.collective_schedule!r}: ag_ar | ag_rs")
        if self.cache_policy not in ("shared_cache", "janus", "none"):
            raise ValueError(f"cache_policy {self.cache_policy!r}: "
                             f"shared_cache | janus | none")

    def axes(self, mesh) -> dict:
        """Logical axis -> mesh axes under ``mode`` ("fsdp" and "dp" a
        tuple, "tp" and "sp" a name or None)."""
        names = list(mesh.axis_names)
        dp = tuple(n for n in ("pod", "data") if n in names)
        tp: Any = "model" if "model" in names else None
        if tp is not None and "node" in names:
            tp = ("node", "model")
        if self.mode == "model_centric":
            return {"fsdp": (), "tp": tp, "dp": dp, "sp": tp}
        if self.mode == "data_centric":
            # paper §4.3: pure data parallelism — every device computes its
            # own batch shard; params sharded over the whole mesh and
            # gathered at use.
            tp_axes = tp if isinstance(tp, tuple) else ((tp,) if tp else ())
            all_axes = dp + tp_axes
            return {"fsdp": all_axes, "tp": None, "dp": all_axes, "sp": None}
        # "auto" keeps the hybrid placement, the superset both per-layer
        # dispatches run from; "ep" shards experts over "tp".
        return {"fsdp": dp, "tp": tp, "dp": dp, "sp": tp}


def as_axes(entry) -> tuple:
    """The mesh axes of a spec entry (or an axes argument): None -> (),
    a name -> (name,), a tuple or list -> a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def resolve_spec(logical: Sequence, cfg: ParallelConfig, mesh) -> tuple:
    """A logical spec tuple -> a physical one (``axes`` of ``cfg.mode``)."""
    table = cfg.axes(mesh)
    out = []
    for entry in logical:
        phys: list = []
        for part in as_axes(entry):
            phys.extend(as_axes(table.get(part, part)))
        out.append(None if not phys else
                   phys[0] if len(phys) == 1 else tuple(phys))
    return tuple(out)


def divisible_spec(shape, spec: Sequence, mesh) -> tuple:
    """Drop the axes of each entry that would not divide its dimension
    (greedily, major first), as GSPMD leaves such a dimension whole."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        keep: list = []
        extent = 1
        for a in as_axes(entry):
            if dim % (extent * mesh.shape[a]) == 0:
                keep.append(a)
                extent *= mesh.shape[a]
        out.append(None if not keep else
                   keep[0] if len(keep) == 1 else tuple(keep))
    return tuple(out)


def physical_spec(shape, logical: Sequence, cfg: ParallelConfig,
                  mesh) -> tuple:
    """The placement of a tensor of global ``shape`` with ``logical``."""
    return divisible_spec(shape, resolve_spec(logical, cfg, mesh), mesh)


def spec_axes(spec: Sequence) -> tuple:
    """Every mesh axis a physical spec names, in its order."""
    return tuple(a for entry in spec for a in as_axes(entry))


def shard(full: torch.Tensor, logical: Sequence, cfg: ParallelConfig,
          mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``logical``: a contiguous copy
    of its own (16-byte aligned, as the kernels need)."""
    spec = physical_spec(full.shape, logical, cfg, mesh)
    out = full
    for dim, entry in enumerate(spec):
        axes = as_axes(entry)
        if axes:
            n = mesh.size(axes)
            step = full.shape[dim] // n
            out = out.narrow(dim, mesh.index(axes) * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def unshard(local: torch.Tensor, logical: Sequence, cfg: ParallelConfig,
            mesh, shape) -> torch.Tensor:
    """The full tensor of global ``shape`` from every rank's ``local``
    block (collective: every rank calls it)."""
    spec = physical_spec(shape, logical, cfg, mesh)
    out = local
    for dim, entry in enumerate(spec):
        axes = as_axes(entry)
        if axes:
            out = mesh.all_gather(out, axes, dim)
    return out


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return None if tree is None else fn(tree, specs)


def shard_tree(tree, specs, cfg: ParallelConfig, mesh):
    """``shard`` over a tree of dicts and lists, ``specs`` a tree of the
    same structure holding each leaf's logical spec."""
    return _map2(lambda t, sp: shard(t, sp, cfg, mesh), tree, specs)


def unshard_tree(tree, specs, shapes, cfg: ParallelConfig, mesh):
    """``unshard`` over a tree; ``shapes`` holds each leaf's global shape
    in a tree of the same structure (collective: every rank calls it)."""
    flat = _map2(lambda t, sp: (t, sp), tree, specs)
    return _map2(lambda ts, shape: unshard(ts[0], ts[1], cfg, mesh, shape),
                 flat, shapes)


def normal_init(shape, dtype: torch.dtype, generator: torch.Generator,
                device, scale: float = 0.02) -> torch.Tensor:
    """Scaled normal init: an f32 draw from ``generator``, cast to dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, scale, generator=generator)
    return w.to(dtype)
