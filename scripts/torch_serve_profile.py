#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's paged engine spends its time,
on one NVIDIA GPU.

    python3 scripts/torch_serve_profile.py [--layers 48] [--steps 8] \
        [--quant none|int8|fp8] [--kv-quant none|int8] [--spec-k K]

Builds qwen3-moe-30b-a3b at full width (``--layers`` cuts depth), fills all
8 slots with 8-token prompts (with ``--quant``/``--kv-quant``: 8-bit
expert weights, quantized layer by layer as drawn, and int8 KV pages),
times ``--steps`` decode macro-steps on the
host clock, then runs as many again under ``torch.profiler`` and prints, as
JSON lines: the step's wall time (unprofiled), the device time summed over
the device's own events (kernels and copies: busy) and the idle share
``1 - busy / wall``, then device time by kernel name (top 25). With
``--spec-k K`` a ``SpecDecoder`` (``NGramDrafter``, k K) runs each decode
step as one verify round a slot (batch-1 chunks of K + 1 tokens), and
the step's tokens, rounds and acceptance are printed too. The card's
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve, spec  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--quant", default="none", choices=["none", "int8", "fp8"])
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    ap.add_argument("--spec-k", type=int, default=0,
                    help="profile speculative verify rounds of k drafts")
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
    params = lm.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda", quant=args.quant)
    slots, page = 8, 16
    server = serve.PagedServer(
        cfg, ParallelConfig(blk=16), num_slots=slots, page_size=page,
        num_pages=1 + slots * 8, max_pages_per_slot=8, params=params,
        kv_quant=args.kv_quant, device="cuda")
    if args.spec_k:
        spec.SpecDecoder(server, spec.NGramDrafter(), k=args.spec_k)
    rng = np.random.default_rng(0)
    for i in range(slots):
        server.submit(serve.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
            max_new=120 if args.spec_k else 64))
    server._admit()
    done: list = []
    while any(st.pos < len(st.req.prompt) for st in server.slots):
        server._prefill_tick(done)
    for _ in range(3):                   # warm-up decode steps
        server._decode_tick(done)
    torch.cuda.synchronize()
    tokens0 = sum(len(st.req.out) for st in server.slots)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        server._decode_tick(done)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    tokens = sum(len(st.req.out) for st in server.slots) - tokens0
    if done:
        print("a request finished inside the timed steps", file=sys.stderr)
        return 1

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            server._decode_tick(done)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops; their kernels are listed
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / args.steps / 1e3, ev.count // args.steps,
                     ev.key))
    if not rows:
        print("the profiler recorded no device events", file=sys.stderr)
        return 1
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(json.dumps({"layers": cfg.num_layers, "slots": slots,
                      "quant": args.quant, "kv_quant": args.kv_quant,
                      "decode_step_wall_ms": wall * 1e3,
                      "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / (wall * 1e3),
                      "kernels_per_step": sum(r[1] for r in rows),
                      "tokens_per_step": tokens / args.steps,
                      "spec_k": args.spec_k,
                      **({"spec": server.spec.stats()} if args.spec_k
                         else {})}))
    for ms, n, name in rows[:25]:
        print(json.dumps({"kernel": name[:90], "ms_per_step": ms,
                          "launches_per_step": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
