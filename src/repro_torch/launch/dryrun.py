"""Multi-pod dry run on the meta device (counterpart of
``repro.launch.dryrun``): one (arch x shape x mesh) cell's parameter
counts, per-rank memory, collectives and roofline, with nothing
allocated.

This is a planner, not a CPU fallback of a card path. The parameters,
the AdamW state, the batch and the dense caches are tensors on
``torch.device("meta")`` (shapes and dtypes, no storage) in one rank's
shard shapes, and one step of the cell (train, dense prefill or dense
decode, the steps ``launch.steps`` builds) runs on them under
``torch.distributed``'s fake backend at the mesh's world size: this
process is rank 0 of a job that does not exist, every collective
returns at once, and every operation computes only its output's shape.
The kernels' wrappers take CUDA or CPU tensors; on meta tensors their
plain versions run instead (``_meta_kernels``), which have the same
output shapes.

What a row reports:

* ``params_total`` and ``params_active``: elements of the global
  parameter tree (``models.lm.param_shapes``), and the same less the
  experts a token does not visit (``(E - k)`` of every MoE layer's
  expert matrices), as the JAX dry run counts them;
* ``memory.argument_bytes``: the exact bytes of rank 0's shards of
  everything the step takes (parameters, optimizer state, batch, cache).
  The dense serving steps take the whole batch of tokens on every rank
  and cut their block (``launch.steps``). Left out against XLA's
  ``memory_analysis()``: the step's temporaries (activations, saved
  tensors, gathered weights, gradients), the allocator's rounding, the
  kernels' workspaces, cuBLAS and NCCL buffers, and the code;
* ``collectives``: every collective the port's ``launch.mesh.Mesh``
  issued in the step, by kind (all-gather, reduce-scatter, all-reduce,
  all-to-all, broadcast), counted once a call over a group of more than
  one rank, with its result bytes (an all-reduce twice, JAX's wire
  model);
* ``roofline``: against ``parallel.autotune.H100_SXM``, the H100's
  rates (not the TPU v5e constants of the JAX dry run): FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the peak rate, the
  argument bytes read once over the memory rate (a floor: the step's
  own traffic is not counted), the collective bytes over the NVLink
  rate;
* ``status``: "ok", "skipped" (``long_500k`` on a full-attention arch,
  as JAX skips it), or "error" with the reason. Operations that cannot
  run on meta (those that read data: ``.item()``, ``.tolist()``,
  ``nonzero``, ``bincount``; and a collective that checks its tensor's
  device) end the cell in an error row, never in a zero.

    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
        --shape train_4k --mesh-shape 2,2,2 --layers-override 4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as cfglib
from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import LONG_CONTEXT_ARCHS, SHAPES
from repro_torch.kernels import esffn, esfk, esmm, ess, estmm
from repro_torch.launch import inputs as inputs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel.autotune import H100_SXM
from repro_torch.parallel.sharding import ParallelConfig, as_axes

#: (module, wrapper) pairs whose plain version ``<wrapper>_plain`` runs
#: on meta tensors: the kernels the LM's steps reach through
#: ``kernels.ops``.
_KERNELS = ((esffn, "esffn_glu"), (esffn, "esffn_mlp"), (esfk, "esfk"),
            (esmm, "esmm"), (ess, "ess"), (estmm, "estmm"))

_COLLECTIVES = (("all_gather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("broadcast0", "broadcast"))


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``world``-rank job on the fake
    backend (``FakeStore``: no rendezvous, no peer; every collective
    completes at once). The process must hold no other group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _meta_kernels():
    """Each kernel wrapper of ``_KERNELS`` runs its plain version on meta
    tensors (its CUDA and CPU calls are left as they are)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in _KERNELS]

    def on_meta(wrapper, plain):
        def call(*args, **kwargs):
            if args[0].device.type == "meta":
                return plain(*args, **kwargs)
            return wrapper(*args, **kwargs)
        return call

    try:
        for mod, name, fn in saved:
            setattr(mod, name, on_meta(fn, getattr(mod, name + "_plain")))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class _CountCollectives:
    """Counts the collectives a ``Mesh`` issues, by kind: calls and result
    bytes (an all-reduce's twice). A call over a group of one rank moves
    nothing and is not counted."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.per_op: dict = {}
        self._saved = {}
        for method, kind in _COLLECTIVES:
            fn = getattr(mesh, method)
            self._saved[method] = fn
            setattr(mesh, method, self._wrap(fn, kind))

    def _wrap(self, fn, kind):
        def call(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            axes = (self.mesh.axis_names if kind == "broadcast"
                    else args[0] if args else kwargs["axes"])
            if self.mesh.size(as_axes(axes)) > 1:
                rec = self.per_op.setdefault(kind, {"bytes": 0, "count": 0})
                rec["bytes"] += (2 if kind == "all-reduce" else 1) \
                    * out.numel() * out.element_size()
                rec["count"] += 1
            return out
        return call

    def restore(self) -> None:
        for method, fn in self._saved.items():
            setattr(self.mesh, method, fn)


def cell_mesh(args, multi_pod: bool):
    """The cell's mesh, as the JAX dry run picks it: ``--mesh-shape``
    over the last of ("pod", "data", "model"); else at 512 ranks the
    production mesh ((2, 16, 16) multi-pod, (16, 16) one pod); else a
    debug pool of ``--devices`` ranks ((2, n/4, 2) or (n/2, 2))."""
    n_dev = args.devices or 512
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        return dims, ("pod", "data", "model")[-len(dims):]
    if n_dev == 512:
        return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                else ((16, 16), ("data", "model")))
    if multi_pod:
        return (2, n_dev // 4, 2), ("pod", "data", "model")
    return (n_dev // 2, 2), ("data", "model")


def default_pcfg(cfg, shape, args) -> ParallelConfig:
    """The cell's parallel mode, as the JAX dry run picks it: "auto" is
    model-centric for a decode cell whose parameters fit 8 GB a rank at
    TP 16, else hybrid; blk 128 (8 to decode), remat by block."""
    mode = args.mode
    if mode == "auto":
        if shape.kind == "decode":
            mode = ("model_centric" if cfg.param_count() * 2 / 16 <= 8e9
                    else "hybrid")
        else:
            mode = "hybrid"
    return ParallelConfig(mode=mode, collective_schedule=args.schedule,
                          cache_policy=args.cache_policy, remat="block",
                          blk=128 if shape.kind != "decode" else 8)


def default_opt_cfg(cfg, n_chips: int) -> adamw.OptimizerConfig:
    """bf16 moments and no f32 master once an f32 master and two f32
    moments (14 bytes a parameter) would pass 12 GB a rank, as JAX's."""
    if cfg.param_count() * 14 / n_chips > 12e9:
        return adamw.OptimizerConfig(state_dtype="bfloat16",
                                     master_fp32=False)
    return adamw.OptimizerConfig(state_dtype="float32", master_fp32=True)


def param_counts(cfg) -> tuple:
    """(total, active) elements of the global parameter tree: active
    leaves out the ``E - k`` experts a token does not visit in every MoE
    layer (3 expert matrices with GLU, else 2)."""
    total = sum(int(np.prod(s)) for s in tree_leaves(lm.param_shapes(cfg)))
    if cfg.moe is None:
        return total, total
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    n_mats = 3 if cfg.glu else 2
    inactive = (n_moe * (cfg.moe.num_experts - cfg.moe.top_k) * n_mats
                * cfg.d_model * cfg.moe.d_ff)
    return total, total - inactive


def _nbytes(trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _step_args(cfg, shape, pcfg, opt_cfg, mesh):
    """The step and rank 0's meta arguments of one cell."""
    params, _ = steps_lib.sharded_params(cfg, pcfg, mesh,
                                         generator=torch.Generator(),
                                         device="meta")
    if shape.kind == "train":
        shape3 = (shape.global_batch, shape.seq_len, cfg.d_model)
        batch = {k: ts.meta(mesh) for k, ts in
                 inputs_lib.input_specs(cfg, shape, pcfg, mesh).items()}
        opt = steps_lib.sharded_opt_state(params, opt_cfg)
        step = steps_lib.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh,
                                         batch_shape3=shape3)
        return step, (params, opt, batch)
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    shape3 = (shape.global_batch, s_in, cfg.d_model)
    # the dense serving steps take every slot's inputs on every rank
    batch = {k: ts.meta() for k, ts in
             inputs_lib.input_specs(cfg, shape, pcfg, None).items()}
    cache = tree_map(lambda ts: ts.meta(mesh),
                     inputs_lib.cache_specs(cfg, shape, pcfg, mesh))
    make = (steps_lib.make_serve_step if shape.kind == "decode"
            else steps_lib.make_prefill_step)
    return make(cfg, pcfg, mesh=mesh, batch_shape3=shape3), \
        (params, batch, cache)


def run_cell(arch: str, shape_name: str, multi_pod: bool, args) -> dict:
    """One cell's report row; an error row, with its reason, where the
    cell cannot run."""
    try:
        return _run_cell(arch, shape_name, multi_pod, args)
    except Exception as e:  # the row reports it; nothing reads as zero
        return {"status": "error", "arch": cfglib.canonical(arch),
                "shape": shape_name, "reason": f"{type(e).__name__}: {e}"}


def _run_cell(arch: str, shape_name: str, multi_pod: bool, args) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cfglib.get_config(arch)
    shape = SHAPES[shape_name]
    canon = cfglib.canonical(arch)
    if args.layers_override:
        n = args.layers_override
        cfg = dataclasses.replace(cfg,
                                  num_layers=max(cfg.period,
                                                 n - n % cfg.period))
    if shape_name == "long_500k" and canon not in LONG_CONTEXT_ARCHS:
        return {"status": "skipped",
                "reason": "pure full-attention arch; see DESIGN.md §4"}
    dims, axes = cell_mesh(args, multi_pod)
    n_chips = int(np.prod(dims))
    pcfg = default_pcfg(cfg, shape, args)
    opt_cfg = default_opt_cfg(cfg, n_chips)
    n_total, n_active = param_counts(cfg)

    t0 = time.time()
    with fake_world(n_chips):
        mesh = make_mesh(dims, axes, device_type="cpu")
        step, step_args = _step_args(cfg, shape, pcfg, opt_cfg, mesh)
        arg_bytes = _nbytes(step_args)
        colls = _CountCollectives(mesh)
        flops = FlopCounterMode(display=False)
        try:
            with _meta_kernels(), flops:
                out = step(*step_args)
        finally:
            colls.restore()
        del out
    t_run = time.time() - t0

    n_flops = float(flops.get_total_flops())
    coll_bytes = sum(v["bytes"] for v in colls.per_op.values())
    t_comp = n_flops / H100_SXM.peak_flops
    t_mem = arg_bytes / H100_SXM.hbm_bw
    t_coll = coll_bytes / H100_SXM.link_bw
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens \
        / n_chips
    dom = max((("compute", t_comp), ("memory", t_mem),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "status": "ok",
        "arch": canon,
        "shape": shape_name,
        "mesh": dict(zip(axes, dims)),
        "chips": n_chips,
        "mode": pcfg.mode,
        "schedule": pcfg.collective_schedule,
        "blk": pcfg.blk,
        "params_total": int(n_total),
        "params_active": int(n_active),
        "opt_state_dtype": opt_cfg.state_dtype,
        "master_fp32": opt_cfg.master_fp32,
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "not_counted": ["the step's temporaries",
                            "allocator rounding and fragmentation",
                            "kernel workspaces", "cuBLAS and NCCL buffers",
                            "code"],
        },
        "accounting": "one meta step on the fake backend (exact shapes)",
        "flops_per_device": n_flops,
        "collective_bytes_per_device": coll_bytes,
        "collectives": colls.per_op,
        "roofline": {
            "hardware": "H100 SXM (parallel.autotune.H100_SXM)",
            "t_compute_s": t_comp,
            "t_memory_args_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": dom,
            "model_flops_per_device": model_flops,
            "useful_flops_fraction": (model_flops / n_flops if n_flops
                                      else None),
        },
    }


def main(argv: Optional[list] = None) -> dict:
    """CLI: dry-run one cell and print (and with ``--out`` write) its
    JSON report row."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--devices", type=int, default=None,
                    help="a smaller pool of fake ranks than 512")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. '4,2' or '2,2,2'")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "hybrid", "model_centric",
                             "data_centric", "ep"])
    ap.add_argument("--schedule", default="ag_rs", choices=["ag_rs", "ag_ar"])
    ap.add_argument("--cache-policy", default="shared_cache",
                    choices=["shared_cache", "janus", "none"])
    ap.add_argument("--layers-override", type=int, default=None,
                    help="cut the depth (rounded down to a period)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    result = run_cell(args.arch, args.shape, args.multi_pod, args)
    blob = json.dumps(result, indent=1, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob)
    print(blob)
    if result["status"] == "ok":
        print(f"\nDRYRUN OK {args.arch} {args.shape} mesh={result['mesh']} "
              f"dominant={result['roofline']['dominant']}")
    return result


if __name__ == "__main__":
    main()
