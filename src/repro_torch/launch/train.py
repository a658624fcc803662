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
with ``models.lm.forward`` outside the train step. Not here
(ROADMAP.md): ``--hetero-replan`` and ``--simulate-skew`` (A.6), and the
fault, observability, checkpoint and resume flags with the
fault-tolerant loop (A.6); ``--no-scan`` has no counterpart, the port's
layer loop being always unrolled. Every LM configuration trains on a
mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
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


def main(argv=None):
    """CLI trainer: a synthetic-data train loop on one device or a mesh."""
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
    args = ap.parse_args(argv)
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
    with contextlib.ExitStack() as stack:
        mesh = None
        if mesh_dims is not None:
            dims, axes = mesh_dims
            device = stack.enter_context(mesh_lib.cli_process_group(
                device, int(np.prod(dims))))
            mesh = mesh_lib.make_mesh(dims, axes, device_type=device.type)
        return _train(ap, args, device, mesh, latencies, topo)


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


def _train(ap, args, device, mesh, latencies, topo):
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
                          overlap_dispatch=args.overlap_dispatch)
    plan = None
    if args.hetero_latencies:
        tp_lat = (None if not args.hetero_tp_latencies else parse_latencies(
            ap, args.hetero_tp_latencies, "--hetero-tp-latencies"))
        plan = hetero_lib.make_hetero_plan(
            parse_latencies(ap, args.hetero_latencies, "--hetero-latencies"),
            global_batch=args.global_batch,
            hidden_size=(cfg.moe.d_ff if tp_lat is not None
                         and cfg.moe is not None else None),
            tp_latencies=tp_lat)
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
    # each device's Eq. 1 share is real
    eff_batch = args.global_batch
    if plan is not None and plan.token_counts is not None:
        eff_batch = len(plan.token_counts) * plan.batch_capacity
    shape3 = (eff_batch, args.seq_len, cfg.d_model)
    x_spec = activation_spec(shape3, pcfg, mesh)
    plan_cache = PlanCache(4)
    train_step = plan_cache.fetch(
        (0, None if plan is None else plan.key()),
        lambda: steps_lib.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh,
                                          batch_shape3=shape3))

    metrics_log = []
    t_last = time.perf_counter()
    for step in range(args.steps):
        host = frontend_batch(cfg, source.batch(step), step)
        if plan is not None and plan.token_counts is not None:
            host = hetero_lib.pack_batch(host, plan)
        batch = batch_to(batch_block(host, x_spec, mesh), device)
        params, opt_state, m = train_step(params, opt_state, batch)
        m = {k: float(v) for k, v in m.items()}   # waits for the step
        now = time.perf_counter()
        m["step_time_s"] = now - t_last
        t_last = now
        if device.type == "cuda":
            m["peak_allocated_gb"] = torch.cuda.max_memory_allocated(
                device) / 1e9
        metrics_log.append({"step": step + 1, **m})
        if (step + 1) % args.log_every == 0:
            say(f"step {step + 1:5d} loss {m['loss']:.4f} "
                f"aux {m['aux_loss']:.4f} lr {m['lr']:.2e} "
                f"({m['step_time_s']:.2f}s)")
    if args.metrics_out and mesh_lib.is_rank0():
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f, indent=1)
    say(f"[train] finished at step {args.steps}; final loss "
        f"{metrics_log[-1]['loss']:.4f}" if metrics_log
        else "[train] no steps run")
    return metrics_log


if __name__ == "__main__":
    main()
