#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--layers 4] [--steps 3]

Builds qwen3-moe-30b-a3b at full width (``--layers`` cuts depth) in bf16
with AdamW (f32 masters) and ``remat="block"``, takes one warm-up step on
the synthetic token stream (global batch 4 x 1024 tokens, blk 128), times
``--steps`` train steps on the host clock, then runs as many again under
``torch.profiler`` and prints, as JSON lines: the step's wall time
(unprofiled), the device time summed over the device's own events
(kernels and copies: busy) and the idle share ``1 - busy / wall``, device
time of the kernels launched in the step's ``train_step.adamw`` profiler
range (the optimizer update; the rest of the busy time is the forward
and backward), device time by kind of work
(the port's kernels by name; the rest grouped by what the kernel name
says), then by kernel name (top 30). The card's
name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import batch_to, build_state  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402

# Kernel name fragments -> kind of work, first match wins.
KINDS = (
    ("esffn", "esffn_glu (fused expert FFN)"),
    ("estmm", "estmm (expert dW)"),
    ("esmm", "esmm (expert recompute, t, dX)"),
    ("gemm", "cuBLAS matmuls (head, attention, projections)"),
    ("gemv", "cuBLAS matmuls (head, attention, projections)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("index", "gathers, scatters, index_add"),
    ("scatter", "gathers, scatters, index_add"),
    ("gather", "gathers, scatters, index_add"),
    ("sort", "routing sort and re-index"),
    ("Sort", "routing sort and re-index"),
    ("reduce", "reductions (norms, softmax sums, grad norm)"),
    ("softmax", "reductions (norms, softmax sums, grad norm)"),
    ("elementwise", "elementwise (optimizer, casts, activations)"),
    ("vectorized", "elementwise (optimizer, casts, activations)"),
)



def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=args.layers)
    batch, seq = 4, 1024
    pcfg = ParallelConfig(blk=min(128, max(16, seq // 4)), remat="block")
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                    decay_steps=40)
    params, opt_state = build_state(cfg, opt_cfg, 0, "cuda")
    source = TokenSource(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab_size=cfg.vocab_size, seed=0))
    train_step = steps.make_train_step(cfg, pcfg, opt_cfg)
    batches = [batch_to(source.batch(i), "cuda")
               for i in range(2 * args.steps + 1)]

    def run(i):
        _, _, m = train_step(params, opt_state, batches[i])
        return float(m["loss"])          # waits for the step

    run(0)                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        run(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps + 1, 2 * args.steps + 1):
            run(i)
        torch.cuda.synchronize()
    return report(prof, args.steps, wall, KINDS,
                  {"layers": cfg.num_layers, "tokens": batch * seq,
                   "train_step_wall_ms": wall * 1e3,
                   "tokens_per_s": batch * seq / wall})


def report(prof, steps: int, wall: float, kinds_table, head: dict) -> int:
    """Print, as JSON lines, ``head`` with the device busy time a step
    (summed over the device's own events), the idle share ``1 - busy /
    wall`` and the device events a step; the device time of the kernels
    launched in each ``train_step.*`` profiler range; device time and
    launches a step by kind of work (``kinds_table``: name fragment ->
    kind, first match wins); the top 30 kernels by name."""
    rows, ranges = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("train_step."):
            # a range shows up as a host event (device time of the kernels
            # it launched) and as a device annotation (its span on the
            # device); neither is a kernel of its own
            ranges[f"{ev.key} ({ev.device_type.name})"] = getattr(
                ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops; their kernels are listed
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / steps / 1e3, ev.count / steps, ev.key))
    if not rows:
        print("the profiler recorded no device events", file=sys.stderr)
        return 1
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(json.dumps({**head, "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / (wall * 1e3),
                      "device_events_per_step": sum(r[1] for r in rows)}))
    print(json.dumps({"range_device_ms_per_step": {
        k: us / steps / 1e3 for k, us in sorted(ranges.items())}}))
    kinds: dict = {}
    for ms, n, name in rows:
        kind = next((k for frag, k in kinds_table if frag in name), "other")
        acc = kinds.setdefault(kind, [0.0, 0.0])
        acc[0] += ms
        acc[1] += n
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"kind": kind, "ms_per_step": ms,
                          "share_of_busy": ms / busy,
                          "launches_per_step": n}))
    for ms, n, name in rows[:30]:
        print(json.dumps({"kernel": name[:90], "ms_per_step": ms,
                          "launches_per_step": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
