#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
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

The serve phase's weights are then freed, and the training slice runs:

6. Kernel phase at training shapes (qwen3-moe-30b-a3b, 4 x 1024 tokens,
   top-8, blk 128: Np 49,024 sorted rows), every shape the LM layer
   launches, on both kernel routes (``_route``: ``wgmma``, bf16 on the
   tensor cores; ``simt``, f32 FMA): ``esmm`` (``ESMM_TRAIN_CASES``) in
   bf16 and f32 at (Np, 2048) x (128, 2048, 768), transposed at the same
   and at (Np, 768) x (128, 2048, 768)^T (the dX products), once with a
   bias, and in bf16 at blk 64 (wgmma) and blk 32 (simt); ``estmm``
   (``ESTMM_TRAIN_CASES``) at (Np, 2048) x (Np, 768) in bf16 and f32, at
   768 x 2048 (dWd), at blk 64 and 32, and once on a layout where 4
   experts have no rows, whose dW must be exactly 0; ``esffn_glu`` at
   N 4096, blk 128. Each call's route is read from the per-route launch
   counts and must be the expected one. Each against its plain version,
   timed as in phase 3, with the time of ``torch._grouped_mm`` (one
   PyTorch call computing the same grouped product) where the installed
   torch has it for the dtype. Negative controls on the head cases' data:
   the plain output with one 64-wide K step left out, and with one
   block's expert swapped for its neighbour's, must each fail the limit.
   Untimed, both kernels also run on the wgmma route at the small and
   ragged ``GEMM_CHECK_WIDTHS`` against their plain versions.
7. Training reference: one ``loss_fn`` forward and backward of a 2-layer
   model at full width in f32 (2 x 64 tokens, blk 16) on the GPU (the
   kernels) and on the CPU (the plain versions) from the same weights and
   batch: the losses must agree within ``TRAIN_LOSS_RTOL`` and every grad
   leaf within ``TRAIN_GRAD_TOL`` x its max |grad|.
8. Train phase: qwen3-moe-30b-a3b at full width and 4 layers in bf16,
   AdamW with f32 masters, ``remat="block"``, the synthetic token stream
   at global batch 4 x 1024 tokens, blk 128: one warm-up step, then 3
   steps through ``make_train_step`` with the launch counts set to 0 just
   before and read just after (per step: 2 ``esffn_glu``, 5 ``esmm`` and
   3 ``estmm`` a layer, every ``esmm`` and ``estmm`` on the wgmma route).
   Every loss must be finite.

The training state is then freed, and the Swin-MoE slice runs (Swin-MoE-
Small, the paper's own benchmark: 8 experts top-1, f32, blk 128):

9. Kernel phase at the Swin train shapes, global batch 128 at 224^2: stage 2
   (N 25,088 tokens, D 384, F 1536: Np 26,112 sorted rows) and stage 3
   (N 6,272, D 768, F 3072: Np 7,296). ``esffn_mlp`` with both biases,
   ``esfk`` and ``ess`` at each (dW1/db1 and dW2/db2 operands), also on a
   layout where 3 experts have no rows (their dW and db exactly 0), with
   the time of the unfused ``estmm`` + ``ess`` pair beside ``esfk``'s, and
   ``esmm`` in f32 with a bias (the z recompute) and transposed (t, dX),
   on the simt route;
   ``esffn_mlp`` once in bf16. Timed as phase 3, against the plain
   versions; ``torch.segment_reduce`` is the library yardstick for ``ess``.
10. Swin reference: Swin-MoE-Small at full width, depth cut to (2, 2, 2, 2)
   (one MoE block each in stages 2 and 3), f32, 2 images: one
   ``make_train_step`` loss and its grads on the GPU (the kernels) and on
   the CPU (the plain versions) from the same weights must agree within
   ``SWIN_LOSS_RTOL`` and ``SWIN_GRAD_TOL``.
11. Swin train: Swin-MoE-Small at full width and depth, global batch
   ``SWIN_BATCH`` of seeded 224^2 images and labels, AdamW
   (``master_fp32=False``): one warm-up step, then ``SWIN_STEPS`` steps
   whose launch counts must be exactly 10 ``esffn_mlp``, 30 ``esmm``, 20
   ``esfk`` and 0 ``ess`` a step, every ``esmm`` on the f32 simt route.
   Then one forward and backward of the same loss from the same state
   with ``set_fused_backward(True)`` and with ``(False)`` (the paper's
   Fig. 12 ablation: 0 ``esfk``, 20 ``estmm``, 20 ``ess``, all on the
   simt route): the grads must agree within
   ``SWIN_ABLATION_TOL``.

The Swin state is then freed, and the flash-attention slice runs (no model
path of either package calls it, so its public entry point is its path):

12. ``flash_attention`` at the ``FLASH_CASES`` (qwen3-moe-30b-a3b's
   attention width at the LM train batch, the head case, and at S 4096;
   gemma3-12b, musicgen-large and gemma-2b heads; one f32 full case): each
   case through the entry point once with the launch count set to 0 before
   and read after, then against ``flash_attention_plain`` (bf16 element by
   element within one output ulp, ``FLASH_BF16_RTOL`` and
   ``FLASH_BF16_ATOL``; f32 within ``FLASH_F32_TOL`` x max|plain|; the head
   case also against the port's ``chunked_attention``), timed as phase 3,
   with ``scaled_dot_product_attention`` as the library yardstick (the
   backend that ran is recorded, and its output is read by the same
   check); then the untimed ``FLASH_CHECK_CASES`` (f32 causal at the head
   shape and at hd 256, and S that leaves partial tiles) against the plain
   version.

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
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the least-time bound of a kernel
# is max(bytes / HBM rate, FLOPs / compute rate of its operand type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ESFFN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # x max|plain|
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-5}    # x max|plain|
# ESMM/ESTMM sum in f32 in another order than cuBLAS; bf16 outputs may
# then round one ulp (2^-8 relative) apart.
GEMM_TOL = {"bfloat16": 1e-2, "float32": 1e-5}    # x max|plain|
# GPU vs CPU in f32 differ by summation order only: measured 0 on the loss
# and 3.7e-6 x max|grad| on the worst grad leaf (H100, 700 W).
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_TOL = 1e-4                             # x max|grad| of the leaf
SERVE_DEPTH = 48
TRAIN_DEPTH = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
# Swin: the f32 kernels sum in another order than the plain versions'
# cuBLAS products (TF32 off): 1e-4 x max|plain| as ESFFN_TOL in f32.
SWIN_KERNEL_TOL = 1e-4
SWIN_LOSS_RTOL = 1e-5
SWIN_GRAD_TOL = 1e-4                              # x max|grad| of the leaf
# fused vs unfused backward on the card: dW is the same sum in the same
# order; db is summed in another (ESFK's rows vs ESS's 32 row lanes), and
# the relative-position tables' grads take atomic adds in no fixed order.
SWIN_ABLATION_TOL = 1e-5                          # x max|grad| of the leaf
SWIN_BATCH, SWIN_STEPS = 128, 3
SWIN_REF_DEPTHS, SWIN_REF_BATCH = (2, 2, 2, 2), 2
# flash attention: kernel and plain version both compute in f32 (in
# another order: 6e-7 apart at most in f32 on an H100) and round once, so
# in bf16 they differ by at most one output ulp (<= 2^-7 |plain|), element
# by element; the 2^-14 floor is for outputs near 0, where an ulp is below
# the f32 noise. Rounding p to bf16 before PV (barred by the kernel's
# contract) moves outputs by more. f32 as tests/test_flash_kernel.py.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 2.0 ** -14
FLASH_F32_TOL = 2e-5                              # x max|plain|
# (case, B, S, Hq, Hkv, hd, dtype, causal); the first is the head case
FLASH_CASES = (
    ("qwen3-moe-30b-a3b train batch", 4, 1024, 32, 4, 128, "bfloat16", True),
    ("qwen3-moe-30b-a3b long context", 1, 4096, 32, 4, 128, "bfloat16", True),
    ("gemma3-12b heads", 2, 2048, 16, 8, 256, "bfloat16", True),
    ("musicgen-large heads (MHA)", 4, 1024, 32, 32, 64, "bfloat16", True),
    ("gemma-2b heads (MQA)", 4, 1024, 8, 1, 256, "bfloat16", True),
    ("qwen3 width, f32, full", 1, 1024, 32, 4, 128, "float32", False),
)
FLASH_CHECK_CASES = (                  # (B, S, Hq, Hkv, hd, dtype, causal)
    (4, 1024, 32, 4, 128, "float32", True),
    (2, 2048, 16, 8, 256, "float32", True),
    (1, 200, 4, 2, 256, "float32", True),
    (2, 200, 8, 2, 128, "float32", True),
    (2, 200, 8, 2, 128, "float32", False),
    (1, 96, 4, 1, 256, "bfloat16", True),
    (1, 80, 4, 4, 64, "float32", True),
)


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


def _sorted_layout(torch, n, empty_experts=0, seed=5, blk=128):
    """qwen3-moe-30b-a3b's routing of n random tokens (top-8 of 128
    experts) on the sorted layout of block size ``blk``; with
    ``empty_experts`` every pick of the first few experts moves to the
    expert ``empty_experts`` places on, so those experts get no rows."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route

    d, e, k = 2048, 128, 8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    x = torch.randn((n, d), generator=gen, device="cuda")
    r = route(x, router, k)
    idx = r.expert_idx
    if empty_experts:
        idx = torch.where(idx < empty_experts, idx + empty_experts, idx)
    return x, build_reindex(idx, r.gates, e, blk), gen


def _check(name, kern, plain, tol_rel):
    if not bool(kern.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (kern.float() - plain.float()).abs().max().item()
    tol = tol_rel * plain.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err, tol


def _flash_err(kern, plain, dtype):
    """(max abs err, worst err / limit, limit): bf16 element by element
    within FLASH_BF16_RTOL |plain| + FLASH_BF16_ATOL, f32 within
    FLASH_F32_TOL x max|plain|. Passes where the worst ratio is <= 1."""
    diff = (kern.float() - plain.float()).abs()
    err = diff.max().item()
    if dtype == "bfloat16":
        lim = FLASH_BF16_RTOL * plain.float().abs() + FLASH_BF16_ATOL
        return err, (diff / lim).max().item(), (
            f"{FLASH_BF16_RTOL} x |plain| + {FLASH_BF16_ATOL}, elementwise")
    tol = FLASH_F32_TOL * plain.float().abs().max().item()
    return err, err / tol, tol


def _check_flash(name, kern, plain, dtype):
    if not bool(kern.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err, ratio, lim = _flash_err(kern, plain, dtype)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: max abs err {err}, {ratio} x the "
                             f"limit {lim}")
    return err, ratio, lim


def _library_ms(torch, flush, fn, dtype):
    """Time of ``torch._grouped_mm`` computing the same grouped product,
    or (None, reason) where this torch has none for the dtype."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    if dtype != "bfloat16":
        return None, "torch._grouped_mm takes bf16 operands only"
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as err:   # the library refused these operands
        return None, f"torch._grouped_mm refused the operands: {err}"
    return time_ms(torch, fn, flush), "torch._grouped_mm"


def _routed(torch, fn, kernel):
    """Call ``fn`` once and return (its output, the route it launched on,
    read from the kernel's per-route counts)."""
    before = dict(kernel.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    moved = [r for r, n in kernel.launches_by_route.items() if n != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"{kernel.__name__}: one call moved the route "
                             f"counts {moved}")
    return out, moved[0]


def _must_fail(name, wrong, plain, tol_rel):
    """Negative control: ``wrong`` (the plain output with a tile-mapping
    fault put in) must fail ``_check`` at the limit the kernels meet.
    Returns its error over the limit."""
    try:
        _check(name, wrong, plain, tol_rel)
    except AssertionError:
        err = (wrong.float() - plain.float()).abs().max().item()
        return err / (tol_rel * plain.float().abs().max().item())
    raise AssertionError(f"negative control {name} passed the limit")


def _rates(case, nbytes, flops):
    """TFLOP/s and GB/s the kernel reached (the bound's bytes and flops
    over its time)."""
    case["tflops"] = flops / case["kernel_ms"] / 1e9
    case["gb_per_s"] = nbytes / case["kernel_ms"] / 1e6
    return case


# Phase 6 cases (dtype, transpose_rhs, bias, K, N, blk, route): every
# shape the LM layer launches (g/u at K 2048 -> N 768, t transposed at the
# same, the two dX products transposed at K 768 -> N 2048), f32 on the
# simt route, and the 64- and 32-row instances.
ESMM_TRAIN_CASES = (
    ("bfloat16", False, False, 2048, 768, 128, "wgmma"),
    ("float32", False, False, 2048, 768, 128, "simt"),
    ("bfloat16", True, False, 2048, 768, 128, "wgmma"),
    ("float32", True, False, 2048, 768, 128, "simt"),
    ("bfloat16", False, True, 2048, 768, 128, "wgmma"),
    ("bfloat16", True, False, 768, 2048, 128, "wgmma"),
    ("bfloat16", False, False, 2048, 768, 64, "wgmma"),
    ("bfloat16", False, False, 2048, 768, 32, "simt"),
)
# (dtype, empty experts, D1, D2, blk, route): dWg/dWu at 2048 x 768, dWd
# at 768 x 2048.
ESTMM_TRAIN_CASES = (
    ("bfloat16", 0, 2048, 768, 128, "wgmma"),
    ("float32", 0, 2048, 768, 128, "simt"),
    ("bfloat16", 4, 2048, 768, 128, "wgmma"),
    ("bfloat16", 0, 768, 2048, 128, "wgmma"),
    ("bfloat16", 0, 2048, 768, 64, "wgmma"),
    ("bfloat16", 0, 2048, 768, 32, "simt"),
)


# Untimed bf16 checks at small and ragged widths on the wgmma route:
# (K, N) for esmm and (D1, D2) for estmm, each at blk 128 and 64, both
# weight orientations, with and without a bias; width 8 is the least the
# route takes, 136 and 200 leave partial K steps and N / D tiles.
GEMM_CHECK_WIDTHS = ((8, 8), (136, 200), (200, 136))


def gemm_check_cases(torch):
    """Phase 6, untimed: esmm and estmm on the wgmma route at the
    GEMM_CHECK_WIDTHS over a random top-2 layout of 8 experts, two of them
    empty, against the plain versions within GEMM_TOL."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.kernels import esmm, estmm

    gen = torch.Generator(device="cuda").manual_seed(13)
    e, worst, n_cases = 8, 0.0, 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for blk in (128, 64):
        idx = torch.randint(2, e, (300, 2), generator=gen, device="cuda")
        lay = build_reindex(idx.int(), torch.rand((300, 2), generator=gen,
                                                  device="cuda"), e, blk)
        be, pc, np_rows = lay.block_expert, lay.padded_counts, \
            lay.row_token.numel()
        for a, b in GEMM_CHECK_WIDTHS:
            for trans in (False, True):
                for bias in (False, True):
                    xs = randn(np_rows, a).bfloat16()
                    w = (randn(e, b, a) if trans else randn(e, a, b)).bfloat16()
                    bv = randn(e, b) if bias else None
                    kern, route = _routed(torch, lambda: esmm.esmm(
                        xs, w, bv, be, transpose_rhs=trans), esmm.esmm)
                    name = (f"esmm check blk {blk} K {a} N {b} trans={trans} "
                            f"bias={bias}")
                    if route != "wgmma":
                        raise AssertionError(f"{name}: took {route}")
                    err, tol = _check(name, kern, esmm.esmm_plain(
                        xs, w, bv, be, transpose_rhs=trans),
                        GEMM_TOL["bfloat16"])
                    worst, n_cases = max(worst, err / tol), n_cases + 1
            x1, x2 = randn(np_rows, a).bfloat16(), randn(np_rows, b).bfloat16()
            kern, route = _routed(torch, lambda: estmm.estmm(x1, x2, be, pc),
                                  estmm.estmm)
            name = f"estmm check blk {blk} D1 {a} D2 {b}"
            if route != "wgmma":
                raise AssertionError(f"{name}: took {route}")
            err, tol = _check(name, kern, estmm.estmm_plain(x1, x2, be, pc),
                              GEMM_TOL["bfloat16"])
            if not torch.equal(kern[pc == 0], torch.zeros_like(kern[pc == 0])):
                raise AssertionError(f"{name}: empty experts not exactly 0")
            worst, n_cases = max(worst, err / tol), n_cases + 1
    print(f"[kernel-train] {n_cases} untimed esmm/estmm wgmma checks at widths "
          f"{GEMM_CHECK_WIDTHS}: worst err {worst:.3f} x the limit")
    return {"cases": n_cases, "worst_err_over_tol": worst}


def _neighbour_swap(be):
    """block_expert with the first block whose neighbour belongs to
    another expert moved to that expert."""
    i = int((be[1:] != be[:-1]).nonzero()[0, 0])
    wrong = be.clone()
    wrong[i] = be[i + 1]
    return wrong


def train_kernel_cases(torch, flush):
    """Phase 6: esmm, estmm and esffn_glu at the train phase's shapes."""
    from repro_torch.core.reindex import gather_rows
    from repro_torch.kernels import esffn, esmm, estmm

    n, d, e, f = TRAIN_BATCH * TRAIN_SEQ, 2048, 128, 768
    x, ri, gen = _sorted_layout(torch, n)
    layouts = {128: ri}
    for blk in (64, 32):
        layouts[blk] = _sorted_layout(torch, n, blk=blk)[1]
    res = {"esmm": [], "estmm": [], "esffn_glu": [], "negative_controls": [],
           "checks": gemm_check_cases(torch)}

    def offsets(lay):
        # offsets of the grouped library call: tail blocks belong to E-1
        offs = torch.cumsum(lay.padded_counts, 0).to(torch.int32)
        offs[-1] = lay.row_token.numel()
        return offs

    def shape_of(lay, blk):
        return {"N": n, "D": d, "E": e, "F": f, "top_k": 8, "blk": blk,
                "Np": lay.row_token.numel(),
                "experts_with_rows": int((lay.padded_counts > 0).sum())}

    for i, (dtype, trans, bias, k_dim, n_dim, blk, want) in enumerate(
            ESMM_TRAIN_CASES):
        td = getattr(torch, dtype)
        lay = layouts[blk]
        be, np_rows, nblk = lay.block_expert, lay.row_token.numel(), \
            lay.block_expert.numel()
        experts = int((lay.padded_counts > 0).sum())
        w = (torch.randn((e, n_dim, k_dim) if trans else (e, k_dim, n_dim),
                         generator=gen, device="cuda") * 0.02).to(td)
        b = ((torch.randn((e, n_dim), generator=gen, device="cuda") * 0.1)
             .to(td) if bias else None)
        # K 2048: the tokens' rows; K 768: a dg-like operand, zero on
        # padding rows as the backward gives it
        xs = (gather_rows(x.to(td), lay.row_token) if k_dim == d else
              (torch.randn((np_rows, k_dim), generator=gen, device="cuda")
               * (lay.row_gate != 0)[:, None]).to(td))
        args = (xs, w, b, be)
        kw = dict(transpose_rhs=trans)
        name = (f"esmm {dtype} trans={trans} bias={bias} K {k_dim} N {n_dim} "
                f"blk {blk}")
        plain = esmm.esmm_plain(*args, **kw)
        kern, route = _routed(torch, lambda: esmm.esmm(*args, **kw),
                              esmm.esmm)
        if route != want:
            raise AssertionError(f"{name}: took the {route} route, not {want}")
        err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
        if i == 0:      # the head case: faults a tile mapping makes
            k0 = 1024
            xs_cut = xs.clone()
            xs_cut[:, k0:k0 + 64] = 0
            res["negative_controls"].append({
                "kernel": "esmm", "fault": f"K step [{k0}, {k0 + 64}) left out",
                "err_over_tol": _must_fail(
                    name + " without one K step",
                    esmm.esmm_plain(xs_cut, w, b, be, **kw), plain,
                    GEMM_TOL[dtype])})
            res["negative_controls"].append({
                "kernel": "esmm", "fault": "one block on its neighbour's expert",
                "err_over_tol": _must_fail(
                    name + " with a block's expert swapped",
                    esmm.esmm_plain(xs, w, b, _neighbour_swap(be), **kw),
                    plain, GEMM_TOL[dtype])})
            del xs_cut
        s_ = xs.element_size()
        nbytes = (np_rows * k_dim * s_ + experts * k_dim * n_dim * s_
                  + (experts * n_dim * s_ if bias else 0) + nblk * 4
                  + np_rows * n_dim * s_)
        flops = 2 * np_rows * k_dim * n_dim
        b_ms, b_by = bound(nbytes, flops, dtype)
        wl = w.transpose(1, 2) if trans else w
        offs = offsets(lay)
        lib_ms, lib_note = _library_ms(
            torch, flush, lambda: torch._grouped_mm(xs, wl, offs=offs), dtype)
        res["esmm"].append(_rates({
            "shape": {**shape_of(lay, blk), "K": k_dim, "Nout": n_dim,
                      "transpose_rhs": trans, "bias": bias},
            "dtype": dtype, "kernel_route": route, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: esmm.esmm(*args, **kw), flush),
            "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(*args, **kw),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del w, b, xs, plain, kern

    for i, (dtype, empty, d1, d2, blk, want) in enumerate(ESTMM_TRAIN_CASES):
        td = getattr(torch, dtype)
        lay_x, lay = (x, layouts[blk]) if not empty else _sorted_layout(
            torch, n, empty_experts=empty, seed=6, blk=blk)[:2]
        lpc, lbe = lay.padded_counts, lay.block_expert
        live = (lay.row_gate != 0)[:, None]
        # D1 2048: the tokens' rows (dWg, dWu); D1 768: an h-like operand
        x1 = (gather_rows(lay_x.to(td), lay.row_token) if d1 == d else
              (torch.randn((live.shape[0], d1), generator=gen, device="cuda")
               * live).to(td))
        x2 = (torch.randn((x1.shape[0], d2), generator=gen, device="cuda")
              * live).to(td)
        args = (x1, x2, lbe, lpc)
        name = f"estmm {dtype} empty={empty} D1 {d1} D2 {d2} blk {blk}"
        plain = estmm.estmm_plain(*args)
        kern, route = _routed(torch, lambda: estmm.estmm(*args), estmm.estmm)
        if route != want:
            raise AssertionError(f"{name}: took the {route} route, not {want}")
        err, tol = _check(name, kern, plain, GEMM_TOL[dtype])
        n_empty = int((lpc == 0).sum())
        if empty and (n_empty < empty
                      or not torch.equal(kern[lpc == 0],
                                         torch.zeros_like(kern[lpc == 0]))):
            raise AssertionError(f"{name}: {n_empty} empty experts, dW not "
                                 f"exactly 0")
        if i == 0:      # the head case: faults a tile mapping makes
            r0 = int(torch.cumsum(lpc, 0)[0])    # expert 1's run starts here
            x1_cut = x1.clone()
            x1_cut[r0:r0 + 64] = 0
            res["negative_controls"].append({
                "kernel": "estmm",
                "fault": f"K step of rows [{r0}, {r0 + 64}) left out",
                "err_over_tol": _must_fail(
                    name + " without one K step",
                    estmm.estmm_plain(x1_cut, x2, lbe, lpc), plain,
                    GEMM_TOL[dtype])})
            res["negative_controls"].append({
                "kernel": "estmm",
                "fault": "one block on its neighbour's expert",
                "err_over_tol": _must_fail(
                    name + " with a block's expert swapped",
                    estmm.estmm_plain(x1, x2, _neighbour_swap(lbe), lpc),
                    plain, GEMM_TOL[dtype])})
            del x1_cut
        rows = _rows_read(lpc, x1.shape[0])
        s_ = x1.element_size()
        nbytes = rows * (d1 + d2) * s_ + e * 4 + e * d1 * d2 * 4
        flops = 2 * rows * d1 * d2
        b_ms, b_by = bound(nbytes, flops, dtype)
        loffs = offsets(lay)
        lib_ms, lib_note = _library_ms(      # writes bf16, not f32
            torch, flush, lambda: torch._grouped_mm(x1.t(), x2, offs=loffs),
            dtype)
        res["estmm"].append(_rates({
            "shape": {**shape_of(lay, blk), "D1": d1, "D2": d2,
                      "empty_experts": n_empty, "rows_read": rows},
            "dtype": dtype, "kernel_route": route, "max_abs_err": err,
            "tolerance": tol,
            "kernel_ms": time_ms(torch, lambda: estmm.estmm(*args), flush),
            "plain_ms": time_ms(torch, lambda: estmm.estmm_plain(*args),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": lib_note}, nbytes, flops))
        del x1, x2, plain, kern

    be, np_rows, nblk = ri.block_expert, ri.row_token.numel(), \
        ri.block_expert.numel()
    experts = int((ri.padded_counts > 0).sum())
    td = torch.bfloat16
    ws = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(td)
          for sh in ((e, d, f), (e, d, f), (e, f, d))]
    xb = x.to(td)
    args = (xb, ri.row_token, ri.row_gate, be, *ws)
    plain = esffn.esffn_glu_plain(*args)
    kern = esffn.esffn_glu(*args)
    torch.cuda.synchronize()
    err, tol = _check("esffn_glu N 4096 blk 128", kern, plain,
                      ESFFN_TOL["bfloat16"])
    live = int((ri.row_gate != 0).sum())
    nbytes = (n * d * 2 + experts * 3 * d * f * 2 + np_rows * 8 + nblk * 4
              + np_rows * d * 2)
    b_ms, b_by = bound(nbytes, 6 * live * d * f, "bfloat16")
    res["esffn_glu"].append({
        "shape": {**shape_of(ri, 128), "live_rows": live},
        "dtype": "bfloat16", "max_abs_err": err, "tolerance": tol,
        "kernel_ms": time_ms(torch, lambda: esffn.esffn_glu(*args), flush),
        "plain_ms": time_ms(torch, lambda: esffn.esffn_glu_plain(*args),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no one PyTorch call computes it"})
    return res


def train_reference_phase(torch):
    """Phase 7: one loss_fn forward + backward of a 2-layer full-width f32
    model on the GPU (kernels) and the CPU (plain versions)."""
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    batch = TokenSource(DataConfig(seq_len=64, global_batch=2,
                                   vocab_size=cfg.vocab_size,
                                   seed=7)).batch(0)
    loss_fn = steps.make_loss_fn(cfg, pcfg)
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(), params)
        total, metrics = loss_fn(p, batch_to(batch, device))
        grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
        out[device] = (float(metrics["loss"].detach()), float(total.detach()),
                       [None if g is None else g.cpu() for g in grads])
        del p, grads
    (lg, tg, gg), (lc, tc, gc) = out["cuda"], out["cpu"]
    if not abs(tg - tc) <= TRAIN_LOSS_RTOL * abs(tc):
        raise AssertionError(f"train reference: GPU loss {tg} vs CPU {tc}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        if (a is None) != (b is None):
            raise AssertionError(f"train reference: grad leaf {i} missing")
        if a is None:
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"train reference: grad leaf {i} "
                                 f"{tuple(b.shape)} err {err} > "
                                 f"{TRAIN_GRAD_TOL} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"[train-reference] 2-layer full-width f32, 2 x 64 tokens: loss "
          f"GPU {lg!r} CPU {lc!r}, total GPU {tg!r} CPU {tc!r} (rel diff "
          f"{abs(tg - tc) / abs(tc):.3e}); {len(gc)} grad leaves, worst max "
          f"|diff| / max |grad| {worst:.3e}")
    return {"loss_gpu": lg, "loss_cpu": lc, "total_rel_diff":
            abs(tg - tc) / abs(tc), "worst_grad_rel": worst}


def train_phase(torch):
    """Phase 8: 4 full-width layers, bf16, AdamW, remat="block"."""
    import math
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.kernels import esffn, esmm, estmm
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to, build_state
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = cfglib.get_config("qwen3-moe-30b-a3b")
    print(f"[train] depth cut: {cfg.num_layers} -> {TRAIN_DEPTH} layers")
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH)
    pcfg = ParallelConfig(blk=min(128, max(16, TRAIN_SEQ // 4)),
                          remat="block")
    opt_cfg = adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                    decay_steps=40, master_fp32=True)
    t0 = time.perf_counter()
    params, opt_state = build_state(cfg, opt_cfg, 0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(params) + tree_leaves(opt_state)
                   if t is not None) / 1e9
    print(f"[train] {cfg.name}: {TRAIN_DEPTH} layers at full width, "
          f"{n_params / 1e9:.3f} B parameters, {state_gb:.2f} GB of bf16 "
          f"weights + f32 masters and moments, built in "
          f"{time.perf_counter() - t0:.1f}s; blk {pcfg.blk}, remat "
          f"{pcfg.remat}")
    source = TokenSource(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab_size=cfg.vocab_size, seed=0))
    train_step = steps.make_train_step(cfg, pcfg, opt_cfg)

    def run(step):
        batch = batch_to(source.batch(step), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = train_step(params, opt_state, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    m, dt = run(0)                        # warm-up, unmeasured
    print(f"[train] warm-up step: loss {m['loss']:.4f} ({dt:.2f}s)")
    torch.cuda.reset_peak_memory_stats()
    for fn in (esffn.esffn_glu, esmm.esmm, estmm.estmm):
        fn.launches = 0
    for fn in (esmm.esmm, estmm.estmm):
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    times, log = [], []
    for step in range(1, TRAIN_STEPS + 1):
        m, dt = run(step)
        times.append(dt)
        log.append(m)
        print(f"[train] step {step}: loss {m['loss']:.6f} aux "
              f"{m['aux_loss']:.6f} z {m['z_loss']:.4f} grad norm "
              f"{m['grad_norm']:.6f} lr {m['lr']:.2e} ({dt:.3f}s)")
    launches = {"esffn_glu": esffn.esffn_glu.launches,
                "esmm": esmm.esmm.launches, "estmm": estmm.estmm.launches}
    routes = {"esmm": dict(esmm.esmm.launches_by_route),
              "estmm": dict(estmm.estmm.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"train: non-finite loss or grad norm {log}")
    want = {"esffn_glu": 2, "esmm": 5, "estmm": 3}
    want = {k: v * TRAIN_DEPTH * TRAIN_STEPS for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    # every expert GEMM of the bf16 LM step on the tensor cores
    want_routes = {k: {"simt": 0, "wgmma": want[k]} for k in routes}
    if routes != want_routes:
        raise AssertionError(f"train: routes {routes}, expected "
                             f"{want_routes}")
    med = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens: step median {med * 1e3:.1f}ms, {tokens / med:.1f} "
          f"tokens/s; peak allocated {peak / 1e9:.2f} GB; launches "
          f"{launches}; routes {routes}")
    return launches, {"steps": log, "step_times_s": times,
                      "launches_by_route": routes,
                      "step_median_ms": med * 1e3,
                      "tokens_per_s": tokens / med,
                      "peak_allocated_gb": peak / 1e9,
                      "layers": TRAIN_DEPTH, "params": n_params,
                      "state_gb": state_gb}


def _swin_layout(torch, n, d, empty_experts=0, seed=8):
    """Swin-MoE-Small's routing of n random tokens of width d (top-1 of 8
    experts, blk 128); with ``empty_experts`` the picks of the first few
    experts move to the expert that many places on, so those get no rows."""
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route

    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = torch.randn((d, 8), generator=gen, device="cuda") * 0.02
    x = torch.randn((n, d), generator=gen, device="cuda")
    r = route(x, router, 1)
    idx = r.expert_idx
    if empty_experts:
        idx = torch.where(idx < empty_experts, idx + empty_experts, idx)
    return x, build_reindex(idx, r.gates, 8, 128), gen


def _rows_read(pc, np_rows):
    """Rows of the non-empty experts' runs (the tail belongs to E-1)."""
    return int(pc.sum()) + (np_rows - int(pc.sum()) if int(pc[-1]) > 0 else 0)


def swin_kernel_cases(torch, flush):
    """Phase 9: esffn_mlp, esfk, ess and f32 biased esmm at the Swin train
    shapes (stage 2 and stage 3 of Swin-MoE-Small at global batch 128)."""
    from repro_torch.core.reindex import gather_rows
    from repro_torch.kernels import esffn, esfk, esmm, ess, estmm

    res = {"esffn_mlp": [], "esfk": [], "ess": [], "esmm": []}
    e = 8
    for stage, n, d in ((2, SWIN_BATCH * 196, 384), (3, SWIN_BATCH * 49, 768)):
        f = 4 * d
        for empty in (0, 3):
            x, ri, gen = _swin_layout(torch, n, d, empty, seed=8 + stage)
            np_rows, nblk = ri.row_token.numel(), ri.block_expert.numel()
            be, pc, rg = ri.block_expert, ri.padded_counts, ri.row_gate
            experts = int((pc > 0).sum())
            n_empty = int((pc == 0).sum())
            if empty and n_empty < empty:
                raise AssertionError(f"swin layout: {n_empty} empty experts")
            live = int((rg != 0).sum())
            rows = _rows_read(pc, np_rows)
            shape = {"stage": stage, "N": n, "D": d, "F": f, "E": e,
                     "top_k": 1, "blk": 128, "Np": np_rows,
                     "live_rows": live, "empty_experts": n_empty}

            def randn(*sh, scale=1.0, g=gen):
                return torch.randn(sh, generator=g, device="cuda") * scale

            w1, w2 = randn(e, d, f, scale=0.02), randn(e, f, d, scale=0.02)
            b1, b2 = randn(e, f, scale=0.1), randn(e, d, scale=0.1)
            dtypes = ("float32", "bfloat16") if stage == 2 and not empty \
                else ("float32",)
            for dtype in dtypes:
                td = getattr(torch, dtype)
                args = (x.to(td), ri.row_token, rg, be, w1.to(td), b1,
                        w2.to(td), b2)
                name = f"esffn_mlp stage {stage} {dtype} empty={n_empty}"
                plain = esffn.esffn_mlp_plain(*args)
                kern = esffn.esffn_mlp(*args)
                torch.cuda.synchronize()
                tol_rel = SWIN_KERNEL_TOL if dtype == "float32" \
                    else ESFFN_TOL["bfloat16"]
                err, tol = _check(name, kern, plain, tol_rel)
                if not torch.equal(kern[rg == 0], torch.zeros_like(
                        kern[rg == 0])):
                    raise AssertionError(f"{name}: padding rows not 0")
                s_ = x.to(td).element_size()
                nbytes = (n * d * s_ + experts * 2 * d * f * s_
                          + experts * (d + f) * 4 + np_rows * 8 + nblk * 4
                          + np_rows * d * s_)
                b_ms, b_by = bound(nbytes, 4 * live * d * f, dtype)
                res["esffn_mlp"].append({
                    "shape": shape, "dtype": dtype, "max_abs_err": err,
                    "tolerance": tol,
                    "kernel_ms": time_ms(torch, lambda: esffn.esffn_mlp(
                        *args), flush),
                    "plain_ms": time_ms(torch, lambda: esffn.esffn_mlp_plain(
                        *args), flush),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: no one PyTorch call computes it"})
                del plain, kern

            # the backward's operands: xs (Np, D) with dz (Np, F) for
            # (dW1, db1), h (Np, F) with dys (Np, D) for (dW2, db2); zero
            # on padding rows, as the backward gives them
            on = (rg != 0)[:, None]
            xs = gather_rows(x, ri.row_token)
            hs, dz, dys = randn(np_rows, f) * on, randn(np_rows, f) * on, \
                randn(np_rows, d) * on
            for x1, x2, what in ((xs, dz, "dW1,db1"), (hs, dys, "dW2,db2")):
                args = (x1, x2, be, pc)
                name = f"esfk stage {stage} {what} empty={n_empty}"
                pw, pb = esfk.esfk_plain(*args)
                kern_w, kern_b = esfk.esfk(*args)
                torch.cuda.synchronize()
                err_w, tol_w = _check(name + " dW", kern_w, pw,
                                      SWIN_KERNEL_TOL)
                err_b, tol_b = _check(name + " db", kern_b, pb,
                                      SWIN_KERNEL_TOL)
                z = pc == 0
                if not (torch.equal(kern_w[z], torch.zeros_like(kern_w[z]))
                        and torch.equal(kern_b[z],
                                        torch.zeros_like(kern_b[z]))):
                    raise AssertionError(f"{name}: empty experts not 0")
                d1, d2 = x1.shape[1], x2.shape[1]
                nbytes = rows * (d1 + d2) * 4 + e * 4 + e * d1 * d2 * 4 \
                    + e * d2 * 4
                b_ms, b_by = bound(nbytes, 2 * rows * d1 * d2 + rows * d2,
                                   "float32")
                res["esfk"].append({
                    "shape": {**shape, "D1": d1, "D2": d2, "grads": what,
                              "rows_read": rows},
                    "dtype": "float32", "max_abs_err": max(err_w, err_b),
                    "tolerance": min(tol_w, tol_b),
                    "kernel_ms": time_ms(torch, lambda: esfk.esfk(*args),
                                         flush),
                    "plain_ms": time_ms(torch, lambda: esfk.esfk_plain(*args),
                                        flush),
                    # the paper's Fig. 12 ablation at the kernel level: the
                    # unfused pair the backward runs instead of ESFK
                    "unfused_estmm_ess_ms": time_ms(torch, lambda: (
                        estmm.estmm(*args), ess.ess(x2, be, pc)), flush),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: no one PyTorch call computes dW and db"})

                args = (x2, be, pc)
                name = f"ess stage {stage} D {d2} empty={n_empty}"
                plain = ess.ess_plain(*args)
                kern = ess.ess(*args)
                torch.cuda.synchronize()
                err, tol = _check(name, kern, plain, SWIN_KERNEL_TOL)
                if not torch.equal(kern[z], torch.zeros_like(kern[z])):
                    raise AssertionError(f"{name}: empty experts not 0")
                # the library call: one segment sum over the expert runs
                # (the tail rows go to E-1), then the empty-expert mask
                lengths = pc.clone()
                lengths[-1] += np_rows - int(pc.sum())
                lib = torch.segment_reduce(x2, "sum", lengths=lengths)
                torch.cuda.synchronize()
                _check(name + " segment_reduce", torch.where(
                    (pc > 0)[:, None], lib, 0.0), plain, SWIN_KERNEL_TOL)
                b_ms, b_by = bound(rows * d2 * 4 + e * 4 + e * d2 * 4,
                                   rows * d2, "float32")
                res["ess"].append({
                    "shape": {**shape, "D": d2, "rows_read": rows},
                    "dtype": "float32", "max_abs_err": err, "tolerance": tol,
                    "kernel_ms": time_ms(torch, lambda: ess.ess(*args), flush),
                    "plain_ms": time_ms(torch, lambda: ess.ess_plain(*args),
                                        flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(torch, lambda: torch.segment_reduce(
                        x2, "sum", lengths=lengths), flush),
                    "library": "torch.segment_reduce"})

            if empty:
                continue
            # f32 ESMM of the MLP backward: z = xs W1 + b1, t = dys W2^T,
            # dX = dz W1^T
            for xa, w, b, trans, what in ((xs, w1, b1, False, "z"),
                                          (dys, w2, None, True, "t"),
                                          (dz, w1, None, True, "dX")):
                args = (xa, w, b, be)
                kw = dict(transpose_rhs=trans)
                name = f"esmm f32 stage {stage} {what}"
                plain = esmm.esmm_plain(*args, **kw)
                kern, route = _routed(torch, lambda: esmm.esmm(*args, **kw),
                                      esmm.esmm)
                if route != "simt":
                    raise AssertionError(f"{name}: took the {route} route")
                err, tol = _check(name, kern, plain, GEMM_TOL["float32"])
                k_dim, n_dim = xa.shape[1], kern.shape[1]
                nbytes = (np_rows * k_dim * 4 + experts * k_dim * n_dim * 4
                          + (experts * n_dim * 4 if b is not None else 0)
                          + nblk * 4 + np_rows * n_dim * 4)
                b_ms, b_by = bound(nbytes, 2 * np_rows * k_dim * n_dim,
                                   "float32")
                res["esmm"].append({
                    "shape": {**shape, "K": k_dim, "Nout": n_dim,
                              "transpose_rhs": trans, "bias": b is not None,
                              "product": what},
                    "dtype": "float32", "kernel_route": route,
                    "max_abs_err": err, "tolerance": tol,
                    "kernel_ms": time_ms(torch, lambda: esmm.esmm(*args, **kw),
                                         flush),
                    "plain_ms": time_ms(torch, lambda: esmm.esmm_plain(
                        *args, **kw), flush),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: torch._grouped_mm takes bf16 only"})
                del plain, kern
            del x, xs, hs, dz, dys, w1, w2, b1, b2
    return res


def _swin_grads(torch, params, loss_fn, images, labels):
    """(loss, grads of every leaf) of one forward and backward."""
    from repro_torch.common import tree_leaves, tree_map

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    total, _ = loss_fn(tree_map(lambda _: next(it), params), images, labels)
    return float(total.detach()), torch.autograd.grad(total, leaves)


def _grad_err(a_grads, b_grads, tol_rel, what):
    worst = 0.0
    for i, (a, b) in enumerate(zip(a_grads, b_grads)):
        a, b = a.float().cpu(), b.float().cpu()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= tol_rel * scale:
            raise AssertionError(f"{what}: grad leaf {i} {tuple(b.shape)} err "
                                 f"{err} > {tol_rel} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def swin_reference_phase(torch):
    """Phase 10: Swin-MoE-Small at full width, cut depth, f32: one loss and
    its grads on the GPU (kernels) and the CPU (plain versions)."""
    from repro_torch.common import tree_map
    from repro_torch.configs import swin_moe_small
    from repro_torch.models import swin
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(swin_moe_small.CONFIG, depths=SWIN_REF_DEPTHS)
    pcfg = ParallelConfig(blk=128)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    # non-zero biases, so that the bias paths carry signal
    params = tree_map(lambda t: t + 0.02 * torch.randn(
        t.shape, generator=gen, device="cuda") if t.ndim <= 2 else t, params)
    images, labels = swin.synthetic_batch(cfg, SWIN_REF_BATCH, generator=gen,
                                          device="cuda")
    loss_fn = swin.make_loss_fn(cfg, pcfg)
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        out[device] = _swin_grads(torch, p, loss_fn, images.to(device),
                                  labels.to(device))
        del p
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    if not abs(lg - lc) <= SWIN_LOSS_RTOL * abs(lc):
        raise AssertionError(f"swin reference: GPU loss {lg} vs CPU {lc}")
    worst = _grad_err(gg, gc, SWIN_GRAD_TOL, "swin reference")
    print(f"[swin-reference] Swin-MoE-Small full width, depths "
          f"{SWIN_REF_DEPTHS}, f32, {SWIN_REF_BATCH} images: loss GPU {lg!r} "
          f"CPU {lc!r} (rel diff {abs(lg - lc) / abs(lc):.3e}); {len(gc)} "
          f"grad leaves, worst max |diff| / max |grad| {worst:.3e}")
    return {"loss_gpu": lg, "loss_cpu": lc,
            "loss_rel_diff": abs(lg - lc) / abs(lc), "worst_grad_rel": worst,
            "depths": list(SWIN_REF_DEPTHS), "images": SWIN_REF_BATCH}


def swin_train_phase(torch):
    """Phase 11: Swin-MoE-Small at full width and depth, f32, AdamW."""
    import math
    from repro_torch.common import tree_leaves
    from repro_torch.configs import swin_moe_small
    from repro_torch.kernels import esffn, esfk, esmm, ess, estmm, ops
    from repro_torch.models import swin
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = swin_moe_small.CONFIG
    pcfg = ParallelConfig(blk=128)
    opt_cfg = adamw.OptimizerConfig(master_fp32=False)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_moe = sum(t.numel() for st in params["stages"] for b in st["blocks"]
                if "moe" in b for t in tree_leaves(b["moe"]))
    print(f"[swin] {cfg.name}: depths {cfg.depths}, dims {cfg.dims}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"{n_params / 1e6:.2f} M parameters ({n_moe / 1e6:.2f} M in the MoE "
          f"blocks), f32, built in {time.perf_counter() - t0:.1f}s; global "
          f"batch {SWIN_BATCH} at {cfg.img_size}^2, blk {pcfg.blk}")
    batches = [swin.synthetic_batch(cfg, SWIN_BATCH, generator=gen,
                                    device="cuda")
               for _ in range(SWIN_STEPS + 1)]
    train_step = swin.make_train_step(cfg, pcfg, opt_cfg)
    kernels = {"esffn_mlp": esffn.esffn_mlp, "esmm": esmm.esmm,
               "esfk": esfk.esfk, "ess": ess.ess, "estmm": estmm.estmm}

    def run(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = train_step(params, opt_state, *batches[i])
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    def reset():
        for fn in kernels.values():
            fn.launches = 0
        for fn in (esmm.esmm, estmm.estmm):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)

    def routes():
        return {"esmm": dict(esmm.esmm.launches_by_route),
                "estmm": dict(estmm.estmm.launches_by_route)}

    m, dt = run(0)                        # warm-up, unmeasured
    print(f"[swin] warm-up step: loss {m['loss']:.4f} ({dt:.2f}s)")
    torch.cuda.reset_peak_memory_stats()
    reset()
    times, log = [], []
    for step in range(1, SWIN_STEPS + 1):
        m, dt = run(step)
        times.append(dt)
        log.append(m)
        print(f"[swin] step {step}: loss {m['loss']:.6f} ce {m['ce']:.6f} aux "
              f"{m['aux_loss']:.6f} grad norm {m['grad_norm']:.6f} lr "
              f"{m['lr']:.2e} ({dt:.3f}s)")
    launches = {k: fn.launches for k, fn in kernels.items()}
    train_routes = routes()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"swin train: non-finite loss or grad norm {log}")
    want = {"esffn_mlp": 10, "esmm": 30, "esfk": 20, "ess": 0, "estmm": 0}
    want = {k: v * SWIN_STEPS for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"swin train: launches {launches}, expected "
                             f"{want}")
    # the f32 Swin step keeps the f32 FMA route
    if train_routes != {"esmm": {"simt": want["esmm"], "wgmma": 0},
                        "estmm": {"simt": 0, "wgmma": 0}}:
        raise AssertionError(f"swin train: routes {train_routes}")
    med = statistics.median(times)
    print(f"[swin] {SWIN_STEPS} steps of {SWIN_BATCH} images: step median "
          f"{med * 1e3:.1f}ms, {SWIN_BATCH / med:.1f} images/s; peak "
          f"allocated {peak / 1e9:.2f} GB; launches {launches}; routes "
          f"{train_routes}")

    # Fig. 12 ablation: the same loss's grads, fused and unfused backward
    loss_fn = swin.make_loss_fn(cfg, pcfg)
    ablation = {}
    for fused in (True, False):
        ops.set_fused_backward(fused)
        try:
            reset()
            loss, grads = _swin_grads(torch, params, loss_fn, *batches[0])
            torch.cuda.synchronize()
        finally:
            ops.set_fused_backward(True)
        ablation[fused] = (loss, grads,
                           {k: fn.launches for k, fn in kernels.items()},
                           routes())
        del grads
    (lf, gf, cf, rf), (lu, gu, cu, ru) = ablation[True], ablation[False]
    if (rf, ru) != ({"esmm": {"simt": 30, "wgmma": 0},
                     "estmm": {"simt": 0, "wgmma": 0}},
                    {"esmm": {"simt": 30, "wgmma": 0},
                     "estmm": {"simt": 20, "wgmma": 0}}):
        raise AssertionError(f"swin backward: routes {rf} fused, {ru} "
                             f"unfused")
    if cf != {"esffn_mlp": 10, "esmm": 30, "esfk": 20, "ess": 0, "estmm": 0}:
        raise AssertionError(f"swin fused backward: launches {cf}")
    if cu != {"esffn_mlp": 10, "esmm": 30, "esfk": 0, "ess": 20, "estmm": 20}:
        raise AssertionError(f"swin unfused backward: launches {cu}")
    if lf != lu:
        raise AssertionError(f"swin ablation: loss {lf} fused vs {lu} unfused")
    worst = _grad_err(gu, gf, SWIN_ABLATION_TOL, "swin ablation")
    print(f"[swin] unfused backward (ESTMM + ESS): launches {cu}; loss equal "
          f"({lf!r}); worst grad max |diff| / max |grad| {worst:.3e} against "
          f"the fused (ESFK) backward")
    launches_by_path = {"swin_train": launches, "swin_unfused_backward": cu}
    return launches_by_path, {
        "launches_by_route": {"swin_train": train_routes,
                              "swin_unfused_backward": ru},
        "config": cfg.name, "params": n_params, "moe_params": n_moe,
        "batch": SWIN_BATCH, "steps": log, "step_times_s": times,
        "step_median_ms": med * 1e3, "images_per_s": SWIN_BATCH / med,
        "peak_allocated_gb": peak / 1e9,
        "ablation_worst_grad_rel": worst}


def _sdpa_ms(torch, flush, q, k, v, causal):
    """The library yardstick: ``scaled_dot_product_attention`` on (B, H, S,
    hd) views, under the first backend of flash, efficient, cuDNN and math
    that takes these inputs. Returns (output, ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a refusal warns, then raises
            try:
                out = call()
                torch.cuda.synchronize()
            except RuntimeError:       # this backend refused the inputs
                continue
            return out.transpose(1, 2), time_ms(torch, call, flush), \
                backend.name
    raise AssertionError("scaled_dot_product_attention: no backend ran")


def flash_cases(torch, flush):
    """Phase 12: flash_attention at full attention widths. Its public entry
    point is its path (no model path runs it): each case goes through it
    once with the launch count set to 0 before and read after; then each
    output is held against the plain version, and timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator(device="cuda").manual_seed(12)

    def inputs(b, s, hq, hkv, hd, dtype):
        td = getattr(torch, dtype)
        return [torch.randn((b, s, h, hd), generator=gen, device="cuda")
                .to(td) for h in (hq, hkv, hkv)]

    args = [inputs(*c[1:7]) for c in FLASH_CASES]
    fa.flash_attention.launches = 0
    outs = [fa.flash_attention(*a, causal=c[7])
            for a, c in zip(args, FLASH_CASES)]
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if launches != len(FLASH_CASES):
        raise AssertionError(f"flash_attention: {launches} launches for "
                             f"{len(FLASH_CASES)} calls")

    cases = []
    for i, ((name, b, s, hq, hkv, hd, dtype, causal), (q, k, v), kern) in \
            enumerate(zip(FLASH_CASES, args, outs)):
        what = f"flash_attention {name}"
        plain = fa.flash_attention_plain(q, k, v, causal=causal)
        err, ratio, lim = _check_flash(what, kern, plain, dtype)
        extra = {}
        if i == 0:                     # the head case
            with torch.no_grad():
                chunked = chunked_attention(q, k, v, causal=causal)
            extra["chunked_attention_err"], extra[
                "chunked_attention_err_over_tol"], _ = _check_flash(
                    what + " vs chunked_attention", kern, chunked, dtype)
            del chunked
        lib, lib_ms, backend = _sdpa_ms(torch, flush, q, k, v, causal)
        # SDPA read by the same check, for the record (it is no port)
        extra["library_max_abs_err"], extra["library_err_over_tol"], _ = \
            _flash_err(lib, plain, dtype)
        itemsize = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s     # live (q, k) pairs
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * itemsize,
                           4 * b * hq * pairs * hd, dtype)
        cases.append({
            "shape": {"case": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv,
                      "hd": hd, "causal": causal},
            "dtype": dtype, "max_abs_err": err, "err_over_tol": ratio,
            "tolerance": lim,
            "kernel_ms": time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=causal), flush),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal), flush, iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": f"torch scaled_dot_product_attention ({backend})",
            **extra})
        print(f"[flash] {name}: err {err:.3g} ({ratio:.3f} x limit), "
              f"SDPA {extra['library_err_over_tol']:.3f} x limit")
        del plain, lib

    # untimed: f32 causal at the head shape and at hd 256 (each kernel
    # instance of hd 256 runs), and S not a multiple of the kernel's
    # 64-row q blocks or of its kv tiles
    for b, s, hq, hkv, hd, dtype, causal in FLASH_CHECK_CASES:
        q, k, v = inputs(b, s, hq, hkv, hd, dtype)
        err, ratio, _ = _check_flash(
            f"flash_attention B {b} S {s} hd {hd} {dtype} causal={causal}",
            fa.flash_attention(q, k, v, causal=causal),
            fa.flash_attention_plain(q, k, v, causal=causal), dtype)
        print(f"[flash] B {b} S {s} {hq}/{hkv} heads hd {hd} {dtype} "
              f"causal={causal}: err {err:.3g} ({ratio:.3f} x limit)")
        del q, k, v
    return launches, cases


def reference_phase(torch):
    """2 layers at full width in f32: GPU (kernels) vs CPU (plain versions)
    from the same weights must give the same greedy tokens."""
    import numpy as np
    from repro_torch import configs as cfglib
    from repro_torch.common import tree_map
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b"),
                              num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
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
    from repro_torch.common import tree_leaves
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
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
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

    torch.cuda.empty_cache()           # the serve phase's weights are gone
    print(f"[train] device memory allocated before training: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    train_res = train_kernel_cases(torch, flush)
    for c in train_res["esmm"] + train_res["estmm"] + train_res["esffn_glu"]:
        print(f"[kernel-train] {json.dumps(c)}")
    for c in train_res["negative_controls"]:
        print(f"[negative-control] {c['kernel']} {c['fault']}: fails at "
              f"{c['err_over_tol']:.3g} x the limit")
    del flush
    torch.cuda.empty_cache()
    train_ref = train_reference_phase(torch)
    torch.cuda.empty_cache()
    train_launches, train_out = train_phase(torch)
    print(f"[train] {json.dumps({**train_out, 'reference': train_ref})}")
    torch.cuda.empty_cache()               # the qwen training state is gone
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    swin_res = swin_kernel_cases(torch, flush)
    for c in sum(swin_res.values(), []):
        print(f"[kernel-swin] {json.dumps(c)}")
    del flush
    torch.cuda.empty_cache()
    swin_ref = swin_reference_phase(torch)
    torch.cuda.empty_cache()
    swin_launches, swin_out = swin_train_phase(torch)
    print(f"[swin] {json.dumps({**swin_out, 'reference': swin_ref})}")
    torch.cuda.empty_cache()               # the Swin training state is gone
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flash_launches, flash_res = flash_cases(torch, flush)
    for c in flash_res:
        print(f"[kernel-flash] {json.dumps(c)}")
    del flush

    # Each kernel's launches on the main paths that ran it: the serve run
    # (phase 5), the qwen train steps (phase 8), the Swin train steps and
    # the unfused-backward pass (phase 11).
    paths = {"serve": launches, "qwen_train": train_launches, **swin_launches}
    by_path = {}
    for path, counts in paths.items():
        for name, n in counts.items():
            if n:
                by_path.setdefault(name, {})[path] = n

    route_paths = {"qwen_train": train_out["launches_by_route"],
                   **swin_out["launches_by_route"]}

    def by_route(name, cases):
        """Each route of a two-route kernel: its launches on each path and
        its first (head) case."""
        out = {}
        for route in ("wgmma", "simt"):
            head = next(c for c in cases if c["kernel_route"] == route)
            out[route] = {
                "launches_by_path": {p: r[name][route] for p, r in
                                     route_paths.items() if r[name][route]},
                "ms": head["kernel_ms"], "bound_ms": head["bound_ms"],
                "library_ms": head.get("library_ms"),
                "max_abs_err": head["max_abs_err"], "shape": head["shape"],
                "dtype": head["dtype"]}
        return out

    def entry(name, source, replaces, cases, **extra):
        head = cases[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path.get(name, {}).values()),
                "launches_by_path": by_path.get(name, {}),
                "max_abs_err": head["max_abs_err"],
                "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head.get("library_ms"),
                "shape": head["shape"], "dtype": head["dtype"],
                "tolerance": head["tolerance"], "cases": cases, **extra}

    print(json.dumps({"kernels": [
        entry("esffn_glu", "src/repro_torch/csrc/esffn.cu",
              "src/repro/kernels/esffn.py:280",
              esffn_res + train_res["esffn_glu"]),
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:295", attn_res),
        entry("esmm", "src/repro_torch/csrc/esmm.cu",
              "src/repro/kernels/esmm.py:80",
              train_res["esmm"] + swin_res["esmm"],
              kernel_routes=by_route("esmm", train_res["esmm"]),
              negative_controls=[c for c in train_res["negative_controls"]
                                 if c["kernel"] == "esmm"]),
        entry("estmm", "src/repro_torch/csrc/estmm.cu",
              "src/repro/kernels/estmm.py:43", train_res["estmm"],
              kernel_routes=by_route("estmm", train_res["estmm"]),
              negative_controls=[c for c in train_res["negative_controls"]
                                 if c["kernel"] == "estmm"],
              small_width_checks=train_res["checks"]),
        entry("esffn_mlp", "src/repro_torch/csrc/esffn.cu",
              "src/repro/kernels/esffn.py:339", swin_res["esffn_mlp"]),
        entry("esfk", "src/repro_torch/csrc/esfk.cu",
              "src/repro/kernels/esfk.py:82", swin_res["esfk"]),
        entry("ess", "src/repro_torch/csrc/ess.cu",
              "src/repro/kernels/ess.py:43", swin_res["ess"]),
        # no model path runs it (launches_by_path is empty): its path is
        # its own entry point, driven once a case in phase 12
        {**entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:80", flash_res),
         "launches": flash_launches,
         "launches_from": "phase 12, the public entry point"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
