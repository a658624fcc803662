"""Trainer of one device (counterpart of ``repro.launch.train``):
synthetic token stream -> train step (forward, autograd backward through
the expert kernels, AdamW) in a plain loop.

    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
        --layers 4 --steps 3 --global-batch 4 --seq-len 1024   # one GPU
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
        --smoke --steps 3 --global-batch 4 --seq-len 64 --device cpu

It runs on the GPU unless ``--device cpu`` is given, and raises where no
GPU is present. ``--layers`` cuts the configuration's depth: AdamW with
f32 masters holds 16 bytes a parameter, so one 80 GB card trains 4 of
qwen3-moe-30b-a3b's 48 full-width layers. The JAX trainer's mesh,
hetero, quantization, topology, fault, observability, checkpoint and
resume flags belong to later slices and are absent here (ROADMAP.md); so
is its fault-tolerant loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import configs as cfglib
from repro_torch.common import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import ParallelConfig


def build_state(cfg, opt_cfg, seed: int, device):
    """Seeded random parameters on ``device`` and their AdamW state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, generator=gen, device=device)
    return params, adamw.init_opt_state(params, opt_cfg)


def batch_to(batch: dict, device) -> dict:
    """A ``TokenSource`` batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
    """CLI trainer: a synthetic-data train loop on one device."""
    # no abbreviations: a later slice's flag must not pass as a prefix of
    # a ported one (--metrics would otherwise mean --metrics-out)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", required=True)
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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    lm.check_supported(cfg)
    pcfg = ParallelConfig(blk=min(128, max(16, args.seq_len // 4)))
    opt_cfg = adamw.OptimizerConfig(
        peak_lr=args.lr, warmup_steps=args.warmup,
        decay_steps=max(args.steps, 2 * args.warmup), master_fp32=True)
    source = TokenSource(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed))
    params, opt_state = build_state(cfg, opt_cfg, args.seed, device)
    train_step = steps_lib.make_train_step(cfg, pcfg, opt_cfg)

    metrics_log = []
    t_last = time.perf_counter()
    for step in range(args.steps):
        batch = batch_to(source.batch(step), device)
        params, opt_state, m = train_step(params, opt_state, batch)
        m = {k: float(v) for k, v in m.items()}   # waits for the step
        now = time.perf_counter()
        m["step_time_s"] = now - t_last
        t_last = now
        metrics_log.append({"step": step + 1, **m})
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1:5d} loss {m['loss']:.4f} "
                  f"aux {m['aux_loss']:.4f} lr {m['lr']:.2e} "
                  f"({m['step_time_s']:.2f}s)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f, indent=1)
    print(f"[train] finished at step {args.steps}; final loss "
          f"{metrics_log[-1]['loss']:.4f}" if metrics_log
          else "[train] no steps run")
    return metrics_log


if __name__ == "__main__":
    main()
