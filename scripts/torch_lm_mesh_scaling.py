#!/usr/bin/env python3
"""The MoE LM's train step on a mesh of several GPUs against one GPU,
through the port's train CLI.

    python3 scripts/torch_lm_mesh_scaling.py [--nproc 4] [--mesh 2,2]
        [--modes hybrid,model_centric,data_centric,ep] [--layers 4]
        [--steps 4] [--out chiprun_out/lm_mesh] [--smoke --device cpu]

Runs ``python -m repro_torch.launch.train`` mesh-less on one device, then
``torchrun --standalone --nproc-per-node NPROC`` of the same CLI with
``--mesh`` in each of ``--modes``: qwen3-moe-30b-a3b at full width cut to
``--layers`` (``--smoke``: its reduced config), bf16, global batch 4 x
1024 tokens (``--seq-len``, ``--global-batch``), seed 0, so every run
draws the same weights and batches. Prints one JSON line a run: the
losses, the step median over the steps after the first (the CLI's host
clock, each step ending when its metrics reach the host), tokens/s, and
the largest loss difference from the one-device run, relative. On the
GPU the kernels are built first (``kernels.build.build``). The card's
name and power limit lead the output (none with ``--device cpu``, the
rehearsal on the CPU's gloo ranks). Each run's log and metrics go to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(cmd, env, log):
    with open(log, "w") as f:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT)
    if proc.returncode:
        sys.stdout.write(Path(log).read_text()[-4000:])
        raise SystemExit(f"{' '.join(cmd)} exited {proc.returncode}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--modes", default="hybrid,model_centric,data_centric,ep")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/lm_mesh")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if args.device == "cuda":
        # every kernel at once (one nvcc a source) before the runs load them
        _run([sys.executable, "-c", "from repro_torch.kernels import build; "
              "build.build()"], env, out / "build.log")
    cli = ["-m", "repro_torch.launch.train", "--arch", "qwen3-moe-30b-a3b",
           "--layers", str(args.layers), "--steps", str(args.steps),
           "--global-batch", str(args.global_batch), "--seq-len",
           str(args.seq_len), "--device", args.device]
    if args.smoke:
        cli.append("--smoke")
    tokens = args.global_batch * args.seq_len
    runs = [("one_device", [sys.executable, *cli])]
    runs += [(mode, [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", str(args.nproc),
                     *cli, "--mesh", args.mesh, "--mode", mode])
             for mode in args.modes.split(",")]
    base = None
    for name, cmd in runs:
        metrics = out / f"{name}.json"
        _run([*cmd, "--metrics-out", str(metrics)], env, out / f"{name}.log")
        log = json.loads(metrics.read_text())
        losses = [m["loss"] for m in log]
        med = statistics.median(m["step_time_s"] for m in log[1:])
        base = losses if base is None else base
        print(json.dumps({
            "run": name, "mesh": None if name == "one_device" else args.mesh,
            "ranks": 1 if name == "one_device" else args.nproc,
            "losses": losses, "step_median_ms": med * 1e3,
            "tokens_per_s": tokens / med,
            "loss_rel_diff": max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, base))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
