#!/usr/bin/env python3
"""The MoE LM on a mesh of several GPUs against one GPU, through the
port's train and serve CLIs.

    python3 scripts/torch_lm_mesh_scaling.py [--nproc 4] [--mesh 2,2]
        [--modes hybrid,model_centric,data_centric,ep] [--layers 4]
        [--steps 4] [--topology INTRA:INTER:NODE] [--overlap-dispatch]
        [--paged] [--out chiprun_out/lm_mesh] [--smoke --device cpu]

Runs ``python -m repro_torch.launch.train`` mesh-less on one device, then
``torchrun --standalone --nproc-per-node NPROC`` of the same CLI with
``--mesh`` in each of ``--modes`` (a mode may name its schedule,
``model_centric:ag_ar``): qwen3-moe-30b-a3b at full width cut to
``--layers`` (``--smoke``: its reduced config), bf16, global batch 4 x
1024 tokens (``--seq-len``, ``--global-batch``), seed 0, so every run
draws the same weights and batches. With ``--topology`` each mode runs
twice, on the flat mesh and with the model extent split into ("node",
"model") by ``--topology``'s node size (the hierarchical schedule), and
each split run's losses must be within 5e-3 of the flat run's, relative
(the script fails otherwise). With ``--overlap-dispatch`` the serve CLI
then decodes on the mesh (``--mode auto --cache-layers 2``; flat, and,
with ``--topology``, split with ``--overlap-dispatch``): 8 greedy
requests of 8 + 16 tokens on 8 slots. With ``--paged`` the paged engine
serves the same requests through the serve CLI (``--paged``, 16-token
pages, a pool of 16, mode auto): on one device, then on the mesh flat
and, with ``--topology``, split. ``--modes ''`` runs no training.

Prints one JSON line a run: train runs the losses, the step median over
the steps after the first (the CLI's host clock, each step ending when
its metrics reach the host), tokens/s, the peak allocated memory on rank
0 and the largest loss difference from the one-device run and from the
flat run of its mode, relative; serve runs the decode step median, the
prefetch cache's line and the first requests' tokens, and whether they
equal the flat run's (and, paged, the one-device run's; bf16, so not
asserted). On the GPU the
kernels are built first (``kernels.build.build``). The card's name and
power limit lead the output (none with ``--device cpu``, the rehearsal
on the CPU's gloo ranks). Each run's log and metrics go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 5e-3


def _run(cmd, env, log):
    with open(log, "w") as f:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT)
    if proc.returncode:
        sys.stdout.write(Path(log).read_text()[-4000:])
        raise SystemExit(f"{' '.join(cmd)} exited {proc.returncode}")
    return Path(log).read_text()


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--modes", default="hybrid,model_centric,data_centric,ep")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--topology", default=None,
                    help="intra_bw:inter_bw:node_size: run each mode also "
                         "with the model extent split into ('node', "
                         "'model')")
    ap.add_argument("--overlap-dispatch", action="store_true",
                    help="then decode through the serve CLI on the mesh "
                         "(auto, --cache-layers 2), split runs with "
                         "--overlap-dispatch")
    ap.add_argument("--paged", action="store_true",
                    help="then serve through the paged engine on one "
                         "device and on the mesh (flat, and split by "
                         "--topology)")
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
    common = ["--arch", "qwen3-moe-30b-a3b", "--layers", str(args.layers),
              "--device", args.device] + (["--smoke"] if args.smoke else [])
    cli = ["-m", "repro_torch.launch.train", *common, "--steps",
           str(args.steps), "--global-batch", str(args.global_batch),
           "--seq-len", str(args.seq_len)]
    dist = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(args.nproc)]
    tokens = args.global_batch * args.seq_len
    layouts = [("flat", [])]
    if args.topology:
        layouts.append(("node", ["--topology", args.topology]))
    modes = [m for m in args.modes.split(",") if m]
    runs = [("one_device", None, [sys.executable, *cli])] if modes else []
    for entry in modes:
        mode, _, sched = entry.partition(":")
        extra = ["--mode", mode] + (["--schedule", sched] if sched else [])
        for layout, flags in layouts:
            runs.append((f"{entry.replace(':', '-')}/{layout}", entry,
                         [*dist, *cli, "--mesh", args.mesh, *extra,
                          *flags]))
    base, flat = None, {}
    for name, entry, cmd in runs:
        metrics = out / f"{name.replace('/', '_')}.json"
        _run([*cmd, "--metrics-out", str(metrics)], env,
             out / f"{name.replace('/', '_')}.log")
        log = json.loads(metrics.read_text())
        losses = [m["loss"] for m in log]
        med = statistics.median(m["step_time_s"] for m in log[1:])
        base = losses if base is None else base
        row = {"run": name, "mesh": None if entry is None else args.mesh,
               "topology": args.topology if name.endswith("/node")
               else None,
               "ranks": 1 if entry is None else args.nproc,
               "losses": losses, "step_median_ms": med * 1e3,
               "tokens_per_s": tokens / med,
               "peak_allocated_gb": log[-1].get("peak_allocated_gb"),
               "loss_rel_diff": _rel(losses, base)}
        if entry is not None and name.endswith("/flat"):
            flat[entry] = losses
        elif entry is not None:
            row["loss_rel_diff_flat"] = _rel(losses, flat[entry])
        print(json.dumps(row), flush=True)
        if row.get("loss_rel_diff_flat", 0.0) > LOSS_RTOL:
            raise SystemExit(f"{name}: losses {losses} against the flat "
                             f"run's {flat[entry]}: beyond {LOSS_RTOL}")
    serve_runs = []
    if args.overlap_dispatch:
        serve = [*dist, "-m", "repro_torch.launch.serve", *common,
                 "--mesh", args.mesh, "--mode", "auto", "--cache-layers",
                 "2", "--slots", "8", "--requests", "8", "--max-new", "16",
                 "--max-seq", "32"]
        srv = [("serve/flat", serve)]
        if args.topology:
            srv.append(("serve/node_overlap", [*serve, "--topology",
                                               args.topology,
                                               "--overlap-dispatch"]))
        serve_runs.append(srv)
    if args.paged:
        paged = ["-m", "repro_torch.launch.serve", *common, "--paged",
                 "--page-size", "16", "--pages", "17", "--mode", "auto",
                 "--slots", "8", "--requests", "8", "--max-new", "16",
                 "--max-seq", "32"]
        on_mesh = [*dist, *paged, "--mesh", args.mesh]
        srv = [("paged/one_device", [sys.executable, *paged]),
               ("paged/flat", on_mesh)]
        if args.topology:
            srv.append(("paged/node", [*on_mesh, "--topology",
                                       args.topology]))
        serve_runs.append(srv)
    for srv in serve_runs:
        first = None
        for name, cmd in srv:
            text = _run(cmd, env, out / f"{name.replace('/', '_')}.log")
            med = re.search(r"decode step: median ([0-9.]+)ms", text)
            rate = re.search(r"tokens in ([0-9.]+)s \(([0-9.]+) tok/s\)",
                             text)
            cache = re.search(r"\[serve\] (prefetch cache|page pool)"
                              r"[^\n]*", text)
            reqs = re.findall(r"  req \d+: [^\n]*", text)
            first = reqs if first is None else first
            print(json.dumps({
                "run": name, "mesh": None if "one_device" in name
                else args.mesh, "ranks": 1 if "one_device" in name
                else args.nproc,
                "decode_step_median_ms": med and float(med.group(1)),
                "wall_s": rate and float(rate.group(1)),
                "tok_per_s": rate and float(rate.group(2)),
                "cache": cache and cache.group(0), "requests": reqs,
                "tokens_equal_first": reqs == first}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
