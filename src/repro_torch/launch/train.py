"""Trainer of one device (counterpart of ``repro.launch.train``):
synthetic token stream -> train step (forward, autograd backward through
the expert kernels, AdamW) in a plain loop, for every LM configuration
of the registry: MoE, dense, hybrid (Mamba + attention + MoE) and
recurrent (xLSTM) stacks, and the frontend families, whose batches are
made as the JAX trainer makes them (``frontend_batch``: seeded SigLIP
patches before the cut token rows for paligemma-3b; seeded EnCodec
frames, 64 rows of T5 conditioning and the labels repeated over the
codebooks for musicgen-large).

    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
        --layers 4 --steps 3 --global-batch 4 --seq-len 1024   # one GPU
    python -m repro_torch.launch.train --arch musicgen-large \\
        --smoke --steps 3 --global-batch 4 --seq-len 64 --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-moe-30b-a3b --smoke --steps 3 --global-batch 4 \\
        --seq-len 64 --device cpu --mesh 2,2 --mode data_centric

It runs on the GPU unless ``--device cpu`` is given, and raises where no
GPU is present. ``--layers`` cuts the configuration's depth: AdamW with
f32 masters holds 16 bytes a parameter, so one 80 GB card trains 4 of
qwen3-moe-30b-a3b's 48 full-width layers. ``--quant int8|fp8`` trains
quantization-aware: the expert weights pass through block-wise
``fake_quant`` inside the MoE layer (straight-through grads) and the
round-tripped weights go to the full-precision kernels.

``--mesh`` (axes the last of ("pod", "data", "model"), as the JAX
trainer's) trains on a ``launch.mesh.Mesh`` over the job's ranks
(``launch.mesh.cli_process_group``: ``torchrun``, ``launch_local``, or a
mesh of one rank in this process), with ``--mode``, ``--schedule``,
``--cache-policy`` and ``--cache-layers`` as ``ParallelConfig`` reads
them and ``--proxy-latencies`` for the auto mode's chooser. Every rank
draws the same weights and the same global batch from the seed and
keeps its blocks (``steps.sharded_params``, ``inputs.batch_block``);
rank 0 prints. ``--hetero-latencies`` (with ``--hetero-tp-latencies``)
builds and runs an Eq. 1/2 ``core.hetero.HeteroPlan``: the weights are
drawn with its padded hidden width, each batch is packed to ``n_devices
x batch_capacity`` rows (``core.hetero.pack_batch``), and the step is
kept in a ``parallel.cache.PlanCache`` under the plan's key.
``--topology`` prices the chooser per interconnect level and, where
``--mesh``'s model extent spans several nodes, splits it into ("node",
"model") (``launch.mesh.split_model_axis``): the MoE islands then run
the hierarchical schedule. ``--overlap-dispatch`` (with
``--cache-layers``) prefetches a data-centric layer's whole expert
weights; the remat'd train step skips the prefetch cache, so it acts
with ``models.lm.forward`` outside the train step. Every LM
configuration trains on a mesh.

The step loop runs through ``runtime.ft.run_with_recovery``, as the JAX
trainer's does: ``--save-every N`` writes an async checkpoint of the
logical state to ``--ckpt-dir`` every N steps (``checkpoint.manager``;
on a mesh gathered, and written by the mesh's first rank), a failed step
restores the newest valid checkpoint and replays, and ``--resume``
starts from it. ``--fault-spec`` installs a ``runtime.faults`` plan
(sites ``train.step``, ``train.loss``, ``train.preempt``,
``ckpt.write``). ``--elastic`` (with ``--mesh``) meets a device dropout
by re-meshing over the survivors (``runtime.elastic``; the ranks left
out return from ``main``) and restoring onto the new mesh.
``--hetero-replan`` closes the straggler loop (``runtime.straggler``:
observed step times re-plan the Eq. 1 shares, one step a plan in the
``PlanCache``); ``--simulate-skew`` synthesises the per-device times on
one host. ``--metrics``, ``--metrics-interval``, ``--trace-out`` and
``--events-out`` write the ``obs`` registry (Prometheus text), the
train-loop spans (Chrome trace) and the event log (JSONL), on rank 0.
``--metrics`` on an MoE config also turns on the router telemetry
(``collect_router_stats``): each step's stats go to a
``RouterStatsDrain`` (phase "train") without a host copy, flushed into
the per-expert series at every metrics dump, as the JAX trainer does.

    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \
        --steps 4 --global-batch 4 --seq-len 64 --device cpu \
        --save-every 2 --ckpt-dir /tmp/ck --metrics /tmp/m.prom \
        --fault-spec '{"faults": [{"site": "train.step", "kind": "error",
                                    "at": 3}]}'
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --layers 1 --steps 4 --global-batch 4 \
        --seq-len 1024 --mesh 2,2 --elastic --save-every 2 --fault-spec \
        '{"faults": [{"site": "train.step", "kind": "device_drop",
                      "at": 3, "payload": {"survivors": 2}}]}'   # 4 GPUs

Two JAX flags have no counterpart: ``--no-scan`` (the port's layer loop
is always unrolled) and ``--impl`` (JAX's choice of kernel
implementation; on the port it would switch the card to the plain
versions, which no entry point runs on a CUDA tensor).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch import obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import resolve_device
from repro_torch.core import hetero as hetero_lib
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.inputs import activation_spec, batch_block
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel.cache import PlanCache
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.runtime import elastic as elastic_lib
from repro_torch.runtime import faults as faults_lib
from repro_torch.runtime import ft as ft_lib
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor


def build_state(cfg, opt_cfg, seed: int, device, *, pcfg=None, mesh=None):
    """Seeded random parameters on ``device`` (padded by
    ``pcfg.hetero_plan``) and their AdamW state; on a ``mesh``, this
    rank's shards of both."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if mesh is not None:
        params, _ = steps_lib.sharded_params(cfg, pcfg, mesh, generator=gen,
                                             device=device)
        return params, steps_lib.sharded_opt_state(params, opt_cfg)
    plan = None if pcfg is None else pcfg.hetero_plan
    params = lm.init_params(cfg, generator=gen, device=device, plan=plan)
    return params, adamw.init_opt_state(params, opt_cfg)


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (``TokenSource``'s, or ``frontend_batch``'s)
    as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


#: The LM configurations of the registry (the Swin ones train through
#: ``models.swin``).
LM_ARCHS = [a for a in cfglib.ALIASES if not a.startswith("swin")]
#: Rows of T5 conditioning in an encodec batch, as the JAX trainer's.
COND_ROWS = 64


def frontend_batch(cfg, batch: dict, step: int) -> dict:
    """A ``TokenSource`` batch (numpy) turned into the inputs of ``cfg``'s
    frontend, as the JAX trainer turns it (``np.random.default_rng(step)``
    draws the features, then f32): encodec: ``embeds`` (B, S,
    frontend_dim), ``cond`` (B, COND_ROWS, cross_d), the labels repeated
    over the codebooks; siglip: ``patches`` (B, prefix_len,
    frontend_dim) and the tokens cut to S - prefix_len, so that the
    forward is S rows long, as the labels are. Other configs: unchanged."""
    if cfg.frontend not in ("encodec", "siglip"):
        return batch
    rng = np.random.default_rng(step)
    b, s = batch["tokens"].shape
    if cfg.frontend == "encodec":
        return {
            "embeds": rng.normal(size=(b, s, cfg.frontend_dim)).astype(
                np.float32),
            "cond": rng.normal(size=(b, COND_ROWS, cfg.cross_d)).astype(
                np.float32),
            "labels": np.repeat(batch["labels"][..., None],
                                cfg.num_codebooks, -1),
            "loss_mask": batch["loss_mask"],
        }
    npatch = cfg.prefix_len
    return {
        "patches": rng.normal(size=(b, npatch, cfg.frontend_dim)).astype(
            np.float32),
        "tokens": batch["tokens"][:, :s - npatch],
        "labels": batch["labels"],
        "loss_mask": batch["loss_mask"],
    }


def parse_latencies(ap, text: str, flag: str) -> tuple:
    try:
        vals = tuple(float(t) for t in text.split(","))
    except ValueError:
        ap.error(f"{flag} must be comma-separated numbers")
    if any(t <= 0 for t in vals):
        ap.error(f"{flag} must all be positive (seconds)")
    return vals


def main(argv=None, *, keep: Optional[int] = None):
    """CLI trainer: a synthetic-data train loop on one device or a mesh,
    through ``runtime.ft.run_with_recovery``. ``keep``: checkpoints kept
    (``FTConfig.keep``; None keeps its default, as the JAX CLI does)."""
    # no abbreviations: a later slice's flag must not pass as a prefix of
    # a ported one (--metrics would otherwise mean --metrics-out)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", required=True, choices=LM_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8"],
                    help="QAT: expert weights pass through block-wise "
                         "int8/fp8 fake-quant inside the MoE layers "
                         "(straight-through grads; routers and the dense "
                         "layers stay full precision)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,4' => data,model; '2,2,2' => "
                         "pod,data,model (torchrun or one rank)")
    ap.add_argument("--mode", default="hybrid",
                    choices=["hybrid", "model_centric", "data_centric",
                             "auto", "ep"],
                    help="'auto' picks data/model-centric per MoE layer "
                         "from the roofline (parallel.autotune)")
    ap.add_argument("--schedule", default="ag_rs", choices=["ag_rs", "ag_ar"])
    ap.add_argument("--cache-policy", default="shared_cache",
                    choices=["shared_cache", "janus", "none"])
    ap.add_argument("--cache-layers", type=int, default=0,
                    help="pipeline-shared prefetch cache residency bound "
                         "(gathered MoE layers); the remat'd train step "
                         "skips it (its cache is --cache-policy)")
    ap.add_argument("--proxy-latencies", default=None,
                    help="comma-separated per-device proxy latencies t_i "
                         "(core.hetero); makes the auto chooser "
                         "heterogeneity-aware")
    ap.add_argument("--hetero-latencies", default=None,
                    help="comma-separated t_i per batch-group member: build "
                         "and run an Eq. 1 uneven token split "
                         "(core.hetero.HeteroPlan). Requires --mesh")
    ap.add_argument("--hetero-tp-latencies", default=None,
                    help="comma-separated t_i per TP-group member: adds the "
                         "Eq. 2 uneven hidden split (padded tiles) to the "
                         "plan")
    ap.add_argument("--hetero-replan", action="store_true",
                    help="close the straggler loop: observed step times "
                         "re-plan the Eq. 1 shares online; each distinct "
                         "plan is one step function (PlanCache)")
    ap.add_argument("--simulate-skew", default=None,
                    help="comma-separated per-worker slowdown factors used "
                         "to synthesise per-device telemetry on a single "
                         "host (demo/test of the replan loop)")
    ap.add_argument("--topology", default=None,
                    help="intra_bw:inter_bw:node_size (e.g. 50e9:12.5e9:4): "
                         "a two-level interconnect. Prices the auto "
                         "chooser's collectives per level and, where the "
                         "mesh's model extent spans several nodes, splits "
                         "it into ('node', 'model') and runs the MoE "
                         "islands' hierarchical dispatch")
    ap.add_argument("--overlap-dispatch", action="store_true",
                    help="prefetch the next data-centric MoE layer's whole "
                         "expert weights (fsdp and tp factor) before the "
                         "current one computes (--mode auto). Requires "
                         "--cache-layers > 0")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable the metrics registry and dump a "
                         "Prometheus text snapshot to PATH at exit "
                         "(DESIGN.md §12)")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="also dump the Prometheus snapshot every N steps "
                         "(0 = exit-only)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record train-loop spans and write a Chrome "
                         "trace-event JSON (Perfetto-loadable) to PATH")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the structured event log (replans, "
                         "recoveries; JSONL) to PATH")
    ap.add_argument("--fault-spec", default=None,
                    help="chaos fault plan: inline JSON or a JSON file "
                         "(runtime.faults; sites train.step / train.loss / "
                         "train.preempt / ckpt.write, DESIGN.md §9)")
    ap.add_argument("--elastic", action="store_true",
                    help="on device dropout, re-mesh over the survivors "
                         "(runtime.elastic.choose_mesh_shape), re-derive "
                         "the hetero plan's token shares, and resume from "
                         "the newest valid checkpoint (requires --mesh)")
    args = ap.parse_args(argv)
    if args.elastic and not args.mesh:
        ap.error("--elastic requires --mesh (nothing to re-mesh)")
    if args.hetero_latencies and not args.mesh:
        ap.error("--hetero-latencies requires --mesh")
    if args.cache_layers < 0:
        ap.error("--cache-layers must be >= 0")
    topo = parse_topology(ap, args.topology)
    if args.overlap_dispatch and args.cache_layers <= 0:
        ap.error("--overlap-dispatch requires --cache-layers > 0 (the "
                 "prefetcher lives in the pipeline-shared cache)")
    latencies = (None if not args.proxy_latencies else
                 parse_latencies(ap, args.proxy_latencies, "--proxy-latencies"))
    mesh_dims = None
    if args.mesh:
        try:
            mesh_dims = mesh_lib.parse_mesh(args.mesh, topo)
        except ValueError as e:
            ap.error(str(e))
    device = resolve_device(args.device)
    if args.fault_spec:
        faults_lib.install(faults_lib.load_plan(args.fault_spec))
    if args.metrics or args.trace_out or args.events_out:
        obs.configure(metrics=bool(args.metrics),
                      tracing=bool(args.trace_out),
                      event_log=bool(args.events_out), reset=True)
    try:
        with contextlib.ExitStack() as stack:
            mesh = None
            if mesh_dims is not None:
                dims, axes = mesh_dims
                device = stack.enter_context(mesh_lib.cli_process_group(
                    device, int(np.prod(dims))))
                mesh = mesh_lib.make_mesh(dims, axes, device_type=device.type)
            return _train(ap, args, device, mesh, latencies, topo, keep)
    finally:
        faults_lib.install(None)


def parse_topology(ap, text):
    """A CLI's ``--topology`` as an ``autotune.Topology`` (None without
    one); a malformed one is an argparse error, as the JAX CLIs make it."""
    if not text:
        return None
    from repro_torch.parallel.autotune import Topology

    try:
        return Topology.parse(text)
    except (ValueError, TypeError) as e:
        ap.error(f"--topology: {e}")


def state_placement(state: dict, cfg, pcfg, mesh):
    """The ``checkpoint.manager.MeshPlacement`` of a train state
    ``{"params", "opt"}`` on ``mesh`` (None without one): the moments and
    masters follow the parameters' logical specs and global shapes (padded
    by ``pcfg.hetero_plan``), the step count is whole on every rank."""
    if mesh is None:
        return None
    specs = lm.param_specs(cfg, pcfg)
    shapes = lm.param_shapes(cfg, plan=pcfg.hetero_plan)
    opt_specs = {k: () if k == "step" else specs for k in state["opt"]}
    opt_shapes = {k: () if k == "step" else shapes for k in state["opt"]}
    return ckpt.MeshPlacement(state, {"params": specs, "opt": opt_specs},
                              {"params": shapes, "opt": opt_shapes},
                              pcfg, mesh)


def _train(ap, args, device, mesh, latencies, topo, keep):
    say = print if mesh_lib.is_rank0() else (lambda *a, **k: None)

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    pcfg = ParallelConfig(blk=min(128, max(16, args.seq_len // 4)),
                          quant=args.quant, mode=args.mode,
                          collective_schedule=args.schedule,
                          cache_policy=args.cache_policy,
                          cache_layers=args.cache_layers,
                          device_latencies=latencies, topology=topo,
                          overlap_dispatch=args.overlap_dispatch,
                          # --metrics adds the per-expert router telemetry
                          collect_router_stats=(bool(args.metrics)
                                                and cfg.moe is not None))
    plan = None
    if args.hetero_latencies:
        tp_lat = (None if not args.hetero_tp_latencies else parse_latencies(
            ap, args.hetero_tp_latencies, "--hetero-tp-latencies"))
        plan = hetero_lib.make_hetero_plan(
            parse_latencies(ap, args.hetero_latencies, "--hetero-latencies"),
            global_batch=args.global_batch,
            hidden_size=(cfg.moe.d_ff if tp_lat is not None
                         and cfg.moe is not None else None),
            tp_latencies=tp_lat,
            capacity_headroom=1.5 if args.hetero_replan else 1.0)
        pcfg = dataclasses.replace(pcfg, hetero_plan=plan)
        say(f"[hetero] plan: token_counts={plan.token_counts} "
            f"(capacity {plan.batch_capacity}/device) "
            f"hidden_splits={plan.hidden_splits}")
    lm.check_mesh(cfg, pcfg, mesh)
    opt_cfg = adamw.OptimizerConfig(
        peak_lr=args.lr, warmup_steps=args.warmup,
        decay_steps=max(args.steps, 2 * args.warmup), master_fp32=True)
    source = TokenSource(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed))
    params, opt_state = build_state(cfg, opt_cfg, args.seed, device,
                                    pcfg=pcfg, mesh=mesh)
    # an uneven plan pads the batch: n_devices x capacity rows, of which
    # each device's Eq. 1 share is real; the shapes are fixed across
    # replans, only the (plan-keyed) step changes
    eff_batch = args.global_batch
    if plan is not None and plan.token_counts is not None:
        eff_batch = len(plan.token_counts) * plan.batch_capacity
    plan_cache = PlanCache(4)
    # single-element boxes: the replan loop and the elastic device-loss
    # handler swap the live mesh, shape and step without re-entering main
    mesh_box = [mesh]
    shape_box = [(eff_batch, args.seq_len, cfg.d_model)]
    x_spec_box = [activation_spec(shape_box[0], pcfg, mesh)]
    mesh_gen = [0]   # bumped per re-mesh so PlanCache keys cannot collide

    def step_for(plan):
        def build():
            return steps_lib.make_train_step(
                cfg, dataclasses.replace(pcfg, hetero_plan=plan), opt_cfg,
                mesh=mesh_box[0], batch_shape3=shape_box[0])
        key = (mesh_gen[0], None if plan is None else plan.key())
        # the chaos wrapper sits OUTSIDE the cache, as in the JAX CLI
        return steps_lib.wrap_step_with_faults(
            plan_cache.fetch(key, build), "train.step")

    cur_plan = [plan]
    step_box = [step_for(plan)]

    start_step = 0
    state = {"params": params, "opt": opt_state}
    placement = state_placement(state, cfg, pcfg, mesh)
    if args.resume:
        last = ckpt.latest_valid_step(args.ckpt_dir)
        if last is not None:
            state, meta = ckpt.restore(args.ckpt_dir, last, state, placement)
            start_step = int(meta["step"])
            say(f"[train] resumed from step {start_step}")

    n_workers = 1
    if plan is not None and plan.token_counts is not None:
        n_workers = len(plan.token_counts)
    monitor = StragglerMonitor(
        num_workers=n_workers, global_batch=args.global_batch,
        cfg=StragglerConfig(window=8, min_steps_between_replans=8),
        plan=plan)
    sim_skew = None
    if args.simulate_skew:
        sim_skew = np.asarray(
            parse_latencies(ap, args.simulate_skew, "--simulate-skew"))
        if len(sim_skew) != n_workers:
            ap.error(f"--simulate-skew needs {n_workers} factors")
    metrics_log = []
    t_last = [time.perf_counter()]
    writes_obs = mesh_lib.is_rank0()
    router_drain = None
    if pcfg.collect_router_stats and writes_obs:
        router_drain = obs.RouterStatsDrain(
            obs.registry, cfg.moe.num_experts, phase="train")

    def dump_obs_metrics():
        if not args.metrics or not writes_obs:
            return
        if router_drain is not None:
            router_drain.flush()
        obs.registry.collect()
        obs.dump_prometheus(obs.registry, args.metrics)

    def step_fn(state, step):
        nonlocal monitor
        t_data0 = time.perf_counter()
        host = frontend_batch(cfg, source.batch(step), step)
        plan = cur_plan[0]
        if plan is not None and plan.token_counts is not None:
            host = hetero_lib.pack_batch(host, plan)
        batch = batch_to(batch_block(host, x_spec_box[0], mesh_box[0]),
                         device)
        obs.tracer.complete("train.data", t_data0, time.perf_counter(),
                            step=step)
        with obs.tracer.span("train.step", step=step):
            params, opt, m = step_box[0](state["params"], state["opt"],
                                         batch)
            # the device-side router stats ride the metrics; the drain
            # takes them before the scalars are read
            rstats = m.pop("router_stats", None)
            if router_drain is not None:
                router_drain.push(rstats)
            m = {k: float(v) for k, v in m.items()}   # waits for the step
        now = time.perf_counter()
        m["step_time_s"] = now - t_last[0]
        t_last[0] = now
        if device.type == "cuda":
            m["peak_allocated_gb"] = torch.cuda.max_memory_allocated(
                device) / 1e9
        obs.registry.histogram(
            "repro_train_step_seconds",
            "Wall time per optimiser step").observe(m["step_time_s"])
        # per-worker telemetry: a deployment feeds host timings here; one
        # host synthesises them from the wall time, the plan's shares and
        # the simulated skew (time_i ~ share_i * skew_i)
        times = [m["step_time_s"]] * n_workers
        if sim_skew is not None:
            shares = np.asarray(
                plan.token_counts if plan is not None
                and plan.token_counts is not None else [1] * n_workers,
                np.float64)
            w = np.maximum(shares, 1e-9) * sim_skew
            times = list(m["step_time_s"] * w / w.mean())
        new_shares = monitor.report(times)
        if new_shares is not None and args.hetero_replan and plan is not None:
            cur_plan[0] = monitor.current_plan()
            step_box[0] = step_for(cur_plan[0])
            st = plan_cache.stats()
            obs.events.emit("train.replan", reason="straggler",
                            step=step, shares=list(new_shares))
            say(f"[hetero] replan -> shares {new_shares} "
                f"(traces: {st['misses']}, reused: {st['hits']})")
        return {"params": params, "opt": opt}, m

    def on_metrics(step, m):
        metrics_log.append({"step": step, **m})
        if args.metrics_interval and step % args.metrics_interval == 0:
            dump_obs_metrics()
        if step % args.log_every == 0:
            say(f"step {step:5d} loss {m['loss']:.4f} "
                f"aux {m['aux_loss']:.4f} lr {m['lr']:.2e} "
                f"({m['step_time_s']:.2f}s)")

    on_device_loss = None
    if args.elastic:
        def on_device_loss(err):
            """Elastic shrink (DESIGN.md §9): re-mesh over the survivors,
            re-derive the plan's token shares (hidden_splits stay fixed:
            they pad the parameter shapes, and the checkpoint must still
            load), swap in a fresh step, and hand ``run_with_recovery``
            the template to restore the newest valid checkpoint into;
            None on a rank the new mesh leaves out."""
            nonlocal n_workers, monitor, sim_skew
            survivors = err.survivors
            ranks = elastic_lib.survivor_ranks(survivors)
            if not ranks:
                raise RuntimeError("device dropout left no devices") \
                    from err
            new_shape = elastic_lib.choose_mesh_shape(len(ranks))
            new_mesh = elastic_lib.make_mesh(
                new_shape, ("data", "model"), ranks, device_type=device.type)
            mesh_box[0] = new_mesh
            mesh_gen[0] += 1
            new_plan = cur_plan[0]
            if (new_plan is not None and new_plan.token_counts is not None
                    and not isinstance(survivors, int)):
                # re-derive ONLY the Eq. 1 token shares over the surviving
                # classes; hidden_splits pad the parameter shapes
                surv_lat = tuple(new_plan.proxy_latencies[int(i)]
                                 for i in survivors)
                tmp = hetero_lib.make_hetero_plan(
                    surv_lat, global_batch=args.global_batch)
                new_plan = dataclasses.replace(
                    new_plan, proxy_latencies=tmp.proxy_latencies,
                    token_counts=tmp.token_counts,
                    token_capacity=tmp.token_capacity)
                shape_box[0] = (
                    len(new_plan.token_counts) * new_plan.batch_capacity,
                    args.seq_len, cfg.d_model)
            cur_plan[0] = new_plan
            if new_plan is not None and new_plan.token_counts is not None:
                n_workers = len(new_plan.token_counts)
                monitor = StragglerMonitor(
                    num_workers=n_workers, global_batch=args.global_batch,
                    cfg=StragglerConfig(window=8,
                                        min_steps_between_replans=8),
                    plan=new_plan)
                if sim_skew is not None and not isinstance(survivors, int):
                    sim_skew = sim_skew[[int(i) for i in survivors]]
            obs.events.emit("train.shrink", reason="device dropout",
                            mesh_shape=list(new_shape),
                            survivors=len(ranks))
            say(f"[elastic] device loss -> re-mesh {new_shape} over "
                f"{len(ranks)} survivors")
            if not new_mesh.member():
                return None
            new_pcfg = dataclasses.replace(pcfg, hetero_plan=new_plan)
            lm.check_mesh(cfg, new_pcfg, new_mesh)
            x_spec_box[0] = activation_spec(shape_box[0], new_pcfg, new_mesh)
            step_box[0] = step_for(new_plan)
            new_placement = state_placement(state, cfg, new_pcfg, new_mesh)
            return new_placement.template(state, device), new_placement

    ft_cfg = ft_lib.FTConfig(ckpt_dir=args.ckpt_dir,
                             save_every=args.save_every)
    if keep is not None:
        ft_cfg = dataclasses.replace(ft_cfg, keep=keep)
    with obs.tracer.span("train.run", steps=args.steps):
        state, last = ft_lib.run_with_recovery(
            state=state, step_fn=step_fn, start_step=start_step,
            num_steps=args.steps, ft=ft_cfg, shardings=placement,
            on_metrics=on_metrics, on_device_loss=on_device_loss)
    if args.metrics_out and mesh_lib.is_rank0():
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f, indent=1)
    if args.metrics and writes_obs:
        dump_obs_metrics()
        say(f"[obs] prometheus metrics -> {args.metrics}")
    if args.trace_out and writes_obs:
        obs.tracer.write(args.trace_out)
        cov = obs.span_coverage(obs.tracer.events)
        say(f"[obs] chrome trace -> {args.trace_out} "
            f"({len(obs.tracer.events)} events, "
            f"span coverage {cov:.1%})")
    if args.events_out and writes_obs:
        obs.events.write_jsonl(args.events_out)
        say(f"[obs] event log -> {args.events_out} "
            f"({len(obs.events.records)} records)")
    say(f"[train] finished at step {last}; "
        f"final loss {metrics_log[-1]['loss']:.4f}"
        if metrics_log else "[train] no steps run")
    return metrics_log


if __name__ == "__main__":
    main()
