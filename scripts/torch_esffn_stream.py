#!/usr/bin/env python3
"""Device time of ``esffn_glu`` on its stream route at qwen3-moe-30b-a3b's
serving shapes, for one checkout of the port, on one NVIDIA GPU.

    python3 scripts/torch_esffn_stream.py [--root CHECKOUT]

Builds the ``esffn`` kernels of CHECKOUT's ``src/repro_torch`` (default:
this checkout) and times ``esffn_glu`` as ``chip_smoke.py``'s phases 3 and
Q1 do (median of 20 calls from CUDA events, the L2 flushed before each):
D 2048, F 768, top-8 of 128 experts, blk 16, at 8 decode slots (N 8) and
the 16-row prefill chunk (N 16), with bf16, f32, int8 and fp8 weights.
Each case is first held against ``esffn_glu_plain`` within
``chip_smoke.ESFFN_TOL``. To compare two versions of the kernel, run it
once per checkout, one after another on the same card, in the order A,
B, B, A.
Prints the card's name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (N, activation dtype, weights: None for the activation dtype, or 8-bit)
CASES = ((8, "bfloat16", None), (16, "bfloat16", None),
         (8, "float32", None), (8, "bfloat16", "int8"),
         (16, "bfloat16", "int8"), (8, "bfloat16", "fp8"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_esffn_stream: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.core.reindex import build_reindex
    from repro_torch.core.routing import route
    from repro_torch.kernels import build, esffn
    from repro_torch.quant.core import quantize_blockwise

    print(chip_smoke.card_line())
    build.build(("esffn",))
    d, e, f, k, blk = 2048, 128, 768, 8, 16
    gen = torch.Generator(device="cuda").manual_seed(21)
    w32 = [chip_smoke._tiled_weights(torch, gen, s)
           for s in ((e, d, f), (e, d, f), (e, f, d))]
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for n, dtype, mode in CASES:
        td = getattr(torch, dtype)
        if mode is None:
            ws, kw = [w.to(td) for w in w32], {}
        else:
            qs = [quantize_blockwise(w, mode=mode) for w in w32]
            ws, kw = [q for q, _ in qs], {"w_scales": tuple(s for _, s in qs)}
        x = torch.randn((n, d), generator=gen, device="cuda").to(td)
        r = route(x, router, k)
        ri = build_reindex(r.expert_idx, r.gates, e, blk)
        call_args = (x, ri.row_token, ri.row_gate, ri.block_expert, *ws)
        name = f"esffn_glu N={n} {dtype} weights={mode or dtype}"
        kern, kroute = chip_smoke._routed(
            torch, lambda: esffn.esffn_glu(*call_args, **kw), esffn.esffn_glu)
        err, tol = chip_smoke._check(
            name, kern, esffn.esffn_glu_plain(*call_args, **kw),
            chip_smoke.ESFFN_TOL[dtype])
        print(json.dumps({
            "root": str(args.root), "case": name, "route": kroute,
            "max_abs_err": err, "tolerance": tol,
            "kernel_ms": chip_smoke.time_ms(
                torch, lambda: esffn.esffn_glu(*call_args, **kw), flush)}))
        del ws, kern
    return 0


if __name__ == "__main__":
    sys.exit(main())
