#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card's name and power limit (``nvidia-smi``).
2. Build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once).
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the served shapes, in bf16 and f32 (TF32 off for the plain versions):
   ``esffn_glu`` at qwen3-moe-30b-a3b's expert shapes (D 2048, E 128,
   F 768, top-8) for N = 8 (decode) and 16 (prefill chunk) at blk 16, and
   blk 128 once; ``paged_attention`` at B 8, Hq 32, Hkv 4, hd 128, page 16
   over ragged lengths (one of them 0) and a page two slots share, with and
   without a window and softcap. Times are medians of CUDA-event-timed
   launches after warm-up, with the L2 cache flushed before each.
4. Reference phase: a 2-layer model at qwen3-moe-30b-a3b's full width in
   float32 served on the GPU (the kernels) and on the CPU (the plain
   versions) from the same weights must give the same greedy tokens.
5. Serve phase: qwen3-moe-30b-a3b at full width and depth (48 layers, about
   61 GB of bf16 weights from a seeded generator) serves 16 greedy requests
   (8-token prompts, 16 new tokens) through ``PagedServer`` with 8 slots and
   16-token pages. The kernels' launch counts are set to 0 just before and
   read just after; both must be positive.

It then prints the kernels' JSON line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the least-time bound of a kernel
# is max(bytes / HBM rate, FLOPs / compute rate of its operand type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ESFFN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # x max|plain|
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-5}    # x max|plain|
SERVE_DEPTH = 48


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call;
    the L2 is flushed before each (and gives the host time to enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def esffn_cases(torch, flush):
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import esffn

    d, e, f, k = 2048, 128, 768, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    w32 = [torch.randn(shape, generator=gen, device="cuda") * 0.02
           for shape in ((e, d, f), (e, d, f), (e, f, d))]
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    cases = []
    for n, blk, dtype in ((8, 16, "bfloat16"), (8, 16, "float32"),
                          (16, 16, "bfloat16"), (16, 16, "float32"),
                          (16, 128, "bfloat16")):
        td = getattr(torch, dtype)
        ws = [w.to(td) for w in w32]
        x = torch.randn((n, d), generator=gen, device="cuda").to(td)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        args = (x, ri.row_token, ri.row_gate, ri.block_expert, *ws)
        plain = esffn.esffn_glu_plain(*args)
        kern = esffn.esffn_glu(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(kern).all():
            raise AssertionError(f"esffn_glu N={n} blk={blk} {dtype}: non-finite")
        err = (kern.float() - plain.float()).abs().max().item()
        tol = ESFFN_TOL[dtype] * plain.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"esffn_glu N={n} blk={blk} {dtype}: max abs "
                                 f"err {err} > {tol}")
        live = (ri.row_gate.reshape(-1, blk) != 0).any(dim=1)
        experts = torch.unique(ri.block_expert[live]).numel()
        itemsize = x.element_size()
        np_rows = ri.row_token.numel()
        nbytes = (n * d * itemsize + experts * 3 * d * f * itemsize
                  + np_rows * (4 + 4) + ri.block_expert.numel() * 4
                  + np_rows * d * itemsize)
        flops = 6 * int((ri.row_gate != 0).sum()) * d * f
        b_ms, b_by = bound(nbytes, flops, dtype)
        cases.append({
            "shape": {"N": n, "D": d, "E": e, "F": f, "top_k": k, "blk": blk,
                      "Np": np_rows, "live_blocks": int(live.sum()),
                      "experts_read": experts},
            "dtype": dtype, "max_abs_err": err, "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(*args), flush),
            "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(*args),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by})
        del ws, plain, kern
    return cases


def paged_attention_cases(torch, flush):
    from repro_torch.kernels import paged_attention as pa

    b, hq, hkv, hd, page = 8, 32, 4, 128, 16
    lengths_l = [0, 1, 9, 16, 17, 24, 100, 250]
    maxp = 16
    gen = torch.Generator(device="cuda").manual_seed(2)
    need = [-(-n // page) for n in lengths_l]
    npages = 1 + sum(need)
    perm = torch.randperm(npages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
    at = 0
    for i, c in enumerate(need):
        table[i, :c] = perm[at:at + c]
        at += c
    table[2, 0] = table[3, 0]           # a page two slots share
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    cases = []
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        q = torch.randn((b, 1, hq, hd), generator=gen, device="cuda").to(td)
        kp = torch.randn((npages, page, hkv, hd), generator=gen,
                         device="cuda").to(td)
        vp = torch.randn((npages, page, hkv, hd), generator=gen,
                         device="cuda").to(td)
        for window, softcap in ((None, 0.0), (32, 30.0)):
            kw = dict(window=window, softcap=softcap)
            args = (q, kp, vp, table, lengths)
            plain = pa.paged_attention_ref(*args, **kw)
            kern = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(kern[0], torch.zeros_like(kern[0])):
                raise AssertionError("paged_attention: empty slot not zero")
            err = (kern.float() - plain.float()).abs().max().item()
            tol = ATTN_TOL[dtype] * plain.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"paged_attention {dtype} window={window}"
                                     f": max abs err {err} > {tol}")
            pages_run, tokens = 0, 0
            for n in lengths_l:
                lo = 0 if window is None else max(n - window, 0)
                tokens += n - lo
                pages_run += sum(1 for j in range(-(-n // page))
                                 if (j + 1) * page > lo)
            itemsize = q.element_size()
            nbytes = (2 * q.numel() * itemsize + table.numel() * 4 + b * 4
                      + 2 * pages_run * page * hkv * hd * itemsize)
            flops = 4 * tokens * hq * hd
            b_ms, b_by = bound(nbytes, flops, dtype)
            cases.append({
                "shape": {"B": b, "Hq": hq, "Hkv": hkv, "hd": hd,
                          "page": page, "maxp": maxp, "lengths": lengths_l,
                          "window": window, "softcap": softcap},
                "dtype": dtype, "max_abs_err": err, "tolerance": tol,
                "kernel_ms": time_ms(torch, lambda: pa.paged_attention(
                    *args, **kw), flush),
                "plain_ms": time_ms(torch, lambda: pa.paged_attention_ref(
                    *args, **kw), flush),
                "bound_ms": b_ms, "bound_by": b_by})
    return cases


def reference_phase(torch):
    """2 layers at full width in f32: GPU (kernels) vs CPU (plain versions)
    from the same weights must give the same greedy tokens."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    cpu_params = _map_tree(lambda t: t.cpu(), params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    streams = {}
    for device, p in (("cuda", params), ("cpu", cpu_params)):
        server = serve.PagedServer(
            cfg, ParallelConfig(blk=16), num_slots=2, page_size=16,
            num_pages=9, max_pages_per_slot=4, params=p, device=device)
        for i, pr in enumerate(prompts):
            server.submit(serve.Request(rid=i, prompt=pr, max_new=4))
        streams[device] = {r.rid: r.out for r in server.run()}
    if streams["cuda"] != streams["cpu"] or len(streams["cuda"]) != 3:
        raise AssertionError(f"reference phase: GPU tokens {streams['cuda']} "
                             f"!= CPU tokens {streams['cpu']}")
    print(f"[reference] 2-layer full-width f32: GPU == CPU greedy tokens "
          f"{streams['cuda']}")


def serve_phase(torch):
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.kernels import esffn, paged_attention
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    if SERVE_DEPTH != cfg.num_layers:
        print(f"[serve] depth cut: {cfg.num_layers} -> {SERVE_DEPTH} layers")
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, expert d_ff "
          f"{cfg.moe.d_ff}, vocab {cfg.vocab_size}: {n_bytes / 1e9:.2f} GB of "
          f"weights, initialised in {time.perf_counter() - t0:.1f}s")

    slots, page, max_seq = 8, 16, 128
    maxp = max_seq // page
    pcfg = ParallelConfig(blk=16)
    rng = np.random.default_rng(0)

    def make_server():
        return serve.PagedServer(
            cfg, pcfg, num_slots=slots, page_size=page,
            num_pages=slots * maxp // 2 + 1, max_pages_per_slot=maxp,
            params=params, prefill_chunk=16, device="cuda")

    warm = make_server()                 # cuBLAS/allocator warm-up, unmeasured
    warm.submit(serve.Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                              max_new=2))
    warm.run()
    del warm

    server = make_server()
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
        max_new=16) for i in range(16)]
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    esffn.esffn_glu.launches = 0
    paged_attention.paged_attention.launches = 0
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"esffn_glu": esffn.esffn_glu.launches,
                "paged_attention": paged_attention.paged_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    tokens = sum(len(r.out) for r in done)
    steps = server.decode_times_s
    if len(done) != 16 or any(len(r.out) != 16 for r in done):
        raise AssertionError("serve: not every request finished with 16 tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("serve: token out of the vocabulary")
    st = server.stats()
    if st["free_pages"] != st["num_pages"] - 1 or st["in_use_pages"]:
        raise AssertionError(f"serve: page pool leaked: {st}")
    server.pool.assert_consistent()
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    ttft = sorted(server.ttft_s.values())
    print(f"[serve] {len(done)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.1f} tok/s); decode step median "
          f"{statistics.median(steps) * 1e3:.2f}ms over {len(steps)} steps; "
          f"TTFT median {statistics.median(ttft) * 1e3:.1f}ms; peak allocated "
          f"{peak / 1e9:.2f} GB; launches {launches}; pool peak "
          f"{st['peak_in_use_pages']} pages, leak-free")
    print(f"  req 0: {done[0].out}")
    return launches, {"requests": len(done), "tokens": tokens, "wall_s": wall,
                      "decode_step_median_ms": statistics.median(steps) * 1e3,
                      "decode_steps": len(steps),
                      "ttft_median_ms": statistics.median(ttft) * 1e3,
                      "peak_allocated_gb": peak / 1e9,
                      "layers": cfg.num_layers}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    out = []
    _map_tree(out.append, tree)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    print(card_line())
    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {sorted(build.KERNELS)} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    esffn_res = esffn_cases(torch, flush)
    attn_res = paged_attention_cases(torch, flush)
    for c in esffn_res + attn_res:
        print(f"[kernel] {json.dumps(c)}")
    del flush
    torch.cuda.empty_cache()

    reference_phase(torch)
    torch.cuda.empty_cache()
    launches, serve_res = serve_phase(torch)
    print(f"[serve] {json.dumps(serve_res)}")

    def entry(name, source, replaces, cases):
        head = cases[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": head["max_abs_err"],
                "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": None,
                "shape": head["shape"], "dtype": head["dtype"],
                "tolerance": head["tolerance"], "cases": cases}

    print(json.dumps({"kernels": [
        entry("esffn_glu", "src/repro_torch/csrc/esffn.cu",
              "src/repro/kernels/esffn.py:280", esffn_res),
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:295", attn_res),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
