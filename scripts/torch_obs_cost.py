#!/usr/bin/env python3
"""What the router telemetry costs the paged engine's decode step, on one
NVIDIA GPU.

    python3 scripts/torch_obs_cost.py [--layers 4] [--rounds 2]

Draws qwen3-moe-30b-a3b at full width cut to ``--layers`` (seeded bf16
weights) once, then serves the serve CLI's traffic (8 slots, 8 requests
of 8 + 16 tokens, greedy) through ``PagedServer`` with the telemetry off
and on in turns (off, on, on, off, ``--rounds`` times), with
``torch.use_deterministic_algorithms`` off and on. "On" is the serve
CLI's ``--metrics --trace-out --events-out``: ``collect_router_stats``,
the drain, spans and the event log. Prints, as JSON lines: each run's
decode-step median (host clock, the tokens on the host); one run of each
setting under ``torch.profiler``: CUDA runtime calls that wait for the
device (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaMemcpy*``), kernels launched and the device time, per decode step
and per prefill chunk; and ``obs.expert_stats`` alone at the decode shape
(64 token slots, 128 experts), host time a call with and without
deterministic algorithms. The card's name and power limit lead the
output.
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
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
         "cudaMemcpy")


def _serve(cfg, params, collect: bool):
    """One run of the CLI's traffic; (server, done)."""
    obs.configure(metrics=collect, tracing=collect, event_log=collect,
                  reset=True)
    pcfg = ParallelConfig(blk=16, collect_router_stats=collect)
    srv = serve.PagedServer(cfg, pcfg, num_slots=8, page_size=16,
                            num_pages=33, max_pages_per_slot=8,
                            params=params, device="cuda")
    rng = np.random.default_rng(0)
    for i in range(8):
        srv.submit(serve.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=8).astype(np.int32), max_new=16))
    done = srv.run()
    torch.cuda.synchronize()
    return srv, done


def _profiled(cfg, params, collect: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv, _ = _serve(cfg, params, collect)
    n = {k: 0 for k in SYNCS}
    kernels, device_us = 0, 0.0
    for e in prof.events():
        if e.name in n:
            n[e.name] += 1
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += e.time_range.elapsed_us()
    chunks = sum(1 for t in srv.trace if t[0] == "prefill_chunk")
    steps = sum(1 for t in srv.trace if t[0] == "decode")
    return {"collect": collect, "prefill_chunks": chunks,
            "decode_steps": steps, "waits": n,
            "device_kernels": kernels, "device_ms": device_us / 1e3,
            "per_forward": {"waits": sum(n.values()) / (chunks + steps),
                            "kernels": kernels / (chunks + steps)}}


def _stats_alone(iters: int = 200) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, 128, (8, 8), generator=gen, device="cuda")
    probs = torch.softmax(torch.randn(8, 128, generator=gen,
                                      device="cuda"), -1)
    out = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for _ in range(10):
            obs.expert_stats(idx, probs, 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            obs.expert_stats(idx, probs, 128)
        torch.cuda.synchronize()
        out[f"deterministic_{det}"] = (time.perf_counter() - t0) / iters * 1e3
    torch.use_deterministic_algorithms(False)
    return {"expert_stats_ms_a_call": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_obs_cost: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build()
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=args.layers)
    params = lm.init_params(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    _serve(cfg, params, False)                        # warm-up
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for _ in range(args.rounds):
            for collect in (False, True, True, False):
                srv, _ = _serve(cfg, params, collect)
                ts = np.asarray(srv.decode_times_s[1:]) * 1e3
                print(json.dumps({"deterministic": det, "collect": collect,
                                  "decode_median_ms": float(np.median(ts)),
                                  "steps": len(ts)}))
        for collect in (False, True):
            print(json.dumps({"deterministic": det,
                              **_profiled(cfg, params, collect)}))
    torch.use_deterministic_algorithms(False)
    obs.configure(metrics=False, tracing=False, event_log=False, reset=True)
    print(json.dumps(_stats_alone()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
