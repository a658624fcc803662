#!/usr/bin/env python3
"""Device time of ``paged_attention`` and ``esffn_mlp`` for one checkout of
the port, on one NVIDIA GPU.

    python3 scripts/torch_kernel_times.py [--root CHECKOUT]

Builds the two kernels of CHECKOUT's ``src/repro_torch`` (default: this
checkout) and times them as ``chip_smoke.py`` does (median of 20 calls
from CUDA events, the L2 flushed before each), on inputs made by this
checkout's ``chip_smoke.py`` from fixed seeds, so two checkouts see the
same data:

* ``paged_attention`` at qwen3-moe-30b-a3b's attention (B 8, Hq 32, Hkv 4,
  hd 128, 16-token pages): the serve phase's decode tables (maxp 2,
  lengths up to 24), phase 3's head case (maxp 16, lengths up to 250) and
  the long context (``chip_smoke.PAGED_LONG``: maxp 2048, lengths up to
  32,768), over bf16 and int8 pools;
* ``esffn_mlp`` at Swin-MoE-Small's stage 2 (N 25,088, D 384, F 1536, 8
  experts top-1, blk 128) in f32, with int8 weights and in bf16, and at
  stage 3 (N 6,272, D 768, F 3072) in f32.

Each case is first held against its plain version at chip_smoke's limit.
To compare two versions of the kernels, run it once per checkout, one
after another on the same card, in the order A, B, B, A. Prints the
card's name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PAGED = (  # (case, maxp, lengths)
    ("serve decode", 2, (1, 7, 9, 16, 17, 24, 20, 12)),
    ("head case", 16, (0, 1, 9, 16, 17, 24, 100, 250)),
    ("long context", cs.PAGED_LONG["maxp"], cs.PAGED_LONG["lengths"]),
)
MLP = (  # (stage, N, D, dtype, weights)
    (2, 25088, 384, "float32", None), (2, 25088, 384, "float32", "int8"),
    (2, 25088, 384, "bfloat16", None), (3, 6272, 768, "float32", None),
)


def paged_cases(flush, root):
    from repro_torch.kernels import paged_attention as pa

    for case, maxp, lengths in PAGED:
        for kv in (None, "int8"):
            gen = torch.Generator(device="cuda").manual_seed(6)
            args, kw = cs._paged_inputs(torch, gen, 8, 32, 4, 128, 16,
                                        lengths, maxp, "bfloat16", kv)
            kern = pa.paged_attention(*args, **kw)
            plain = pa.paged_attention_ref(*args, **kw)
            worst = cs._check_slots(f"paged_attention {case}", kern, plain,
                                    cs.ATTN_TOL["bfloat16"])
            nbytes, flops = cs._paged_work(args, bool(kw), None)
            print(json.dumps({
                "root": str(root), "kernel": "paged_attention", "case": case,
                "maxp": maxp, "kv": kv or "bfloat16",
                "worst_slot_err_over_tol": worst,
                "kernel_ms": cs.time_ms(torch, lambda: pa.paged_attention(
                    *args, **kw), flush),
                "bound_ms": cs.bound(nbytes, flops, "bfloat16")[0]}),
                flush=True)
            del args, kw, kern, plain


def mlp_cases(flush, root):
    from repro_torch.kernels import esffn
    from repro_torch.quant.core import quantize_blockwise

    for stage, n, d, dtype, mode in MLP:
        f = 4 * d
        x, ri, gen = cs._swin_layout(torch, n, d, seed=8 + stage)
        w1 = torch.randn((8, d, f), generator=gen, device="cuda") * 0.02
        w2 = torch.randn((8, f, d), generator=gen, device="cuda") * 0.02
        b1 = torch.randn((8, f), generator=gen, device="cuda") * 0.1
        b2 = torch.randn((8, d), generator=gen, device="cuda") * 0.1
        td = getattr(torch, dtype)
        kw = {}
        if mode is None:
            ws = (w1.to(td), w2.to(td))
        else:
            (q1, s1), (q2, s2) = (quantize_blockwise(w, mode=mode)
                                  for w in (w1, w2))
            ws, kw = (q1, q2), {"w_scales": (s1, s2)}
        args = (x.to(td), ri.row_token, ri.row_gate, ri.block_expert, ws[0],
                b1, ws[1], b2)
        tol = cs.SWIN_KERNEL_TOL if dtype == "float32" \
            else cs.ESFFN_TOL["bfloat16"]
        err, lim = cs._check(f"esffn_mlp stage {stage} {dtype}",
                             esffn.esffn_mlp(*args, **kw),
                             esffn.esffn_mlp_plain(*args, **kw), tol)
        live = int((ri.row_gate != 0).sum())
        print(json.dumps({
            "root": str(root), "kernel": "esffn_mlp", "stage": stage,
            "N": n, "D": d, "F": f, "dtype": dtype,
            "weights": mode or dtype, "err_over_tol": err / lim,
            "kernel_ms": cs.time_ms(torch, lambda: esffn.esffn_mlp(
                *args, **kw), flush),
            "flops": 4 * live * d * f}), flush=True)
        del x, ri, w1, w2, ws, args, kw


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import build

    print(cs.card_line())
    build.build(("paged_attention", "esffn"))
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    paged_cases(flush, args.root)
    mlp_cases(flush, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
