#!/usr/bin/env python3
"""Device time of ``paged_attention``, ``esffn_mlp``, ``esmm``, ``esfk`` and
f32 ``estmm`` for one checkout of the port, on one NVIDIA GPU.

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
  stage 3 (N 6,272, D 768, F 3072) in f32;
* the Swin backward's f32 expert GEMMs at stages 2 and 3, on phase 9's
  operands: ``esmm`` z (with a bias), t and dX, ``esfk`` (dW1, db1) and
  (dW2, db2) (with this checkout's ``esfk`` also at 1, 2, 3, 4, 6 and 8
  CTAs an expert's rows, beside the count its ``_plan`` picks, and the
  same counts with 64-row output tiles: its ``csrc/esfk.cu`` built once
  more with ``-DESFK_TILE_M=64``), and
  ``estmm`` alone on the same operands; and ``esmm``
  with int8 weights and bf16 xs at the LM expert shape (Np 49,024, K
  2048, N 768, blk 128), as phase Q1's head case.

Each case is first held against its plain version at chip_smoke's limit.
To compare two versions of the kernels, run it once per checkout, one
after another on the same card, in the order A, B, B, A. Prints the
card's name and power limit, then one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
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


def _timed(name, fn, plain, tol, flush, root, kernel, **extra):
    """Hold ``fn``'s output (a tensor or a tuple) against ``plain``'s at
    ``tol`` x max|plain|, then print its time and the route it took."""
    outs, wants = fn(), plain()
    outs = outs if isinstance(outs, tuple) else (outs,)
    wants = wants if isinstance(wants, tuple) else (wants,)
    worst = max(err / lim for err, lim in (
        cs._check(name, o, w, tol) for o, w in zip(outs, wants)))
    routes = dict(getattr(kernel, "launches_by_route", {}))
    ms = cs.time_ms(torch, fn, flush)
    moved = [r for r, n in getattr(kernel, "launches_by_route", {}).items()
             if n != routes.get(r)]
    print(json.dumps({"root": str(root), "kernel": kernel.__name__,
                      "case": name, "route": moved[0] if moved else None,
                      "err_over_tol": worst, "kernel_ms": ms, **extra}),
          flush=True)


def _esfk_tile64():
    """``esfk_launch`` of this checkout's ``csrc/esfk.cu`` built with 64-row
    output tiles, or None where the source has no such knob."""
    from repro_torch.kernels import build, esfk

    src = build.CSRC / "esfk.cu"
    if "ESFK_TILE_M" not in src.read_text():
        return None
    lib = build.library_path("esfk")
    lib = lib.with_name(f"{lib.stem}-m64.so")
    if not lib.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DESFK_TILE_M=64",
                        "-o", str(lib), str(src)], check=True,
                       capture_output=True)
    fn = ctypes.CDLL(str(lib)).esfk_launch
    fn.argtypes, fn.restype = esfk._ARGTYPES, ctypes.c_int
    return fn


def _esfk_tile64_call(fn, x1, x2, pc, splits):
    """A call of the 64-row build with ``splits`` CTAs an expert's rows,
    its workspace made here, once (the kernel leaves the tickets 0)."""
    from repro_torch.kernels import esfk

    np_rows, d1 = x1.shape
    d2, e = x2.shape[1], pc.shape[0]
    m_tiles, n_tiles = -(-d1 // 64), -(-d2 // 128)
    parts = torch.empty(m_tiles * n_tiles * e * splits * 64 * 128
                        + e * n_tiles * splits * 128, device="cuda")
    tickets = torch.zeros(m_tiles * n_tiles * e, dtype=torch.int32,
                          device="cuda")

    def call():
        dw = torch.empty((e, d1, d2), device="cuda")
        db = torch.empty((e, d2), device="cuda")
        err = fn(x1.data_ptr(), x2.data_ptr(), pc.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), parts.data_ptr(), tickets.data_ptr(), np_rows,
                 d1, d2, e, 0, esfk._ROUTES["mma_tf32x3"], splits,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"esfk 64-row tiles: CUDA error {err}")
        return dw, db
    return call


def gemm_cases(flush, root):
    from repro_torch.core.reindex import gather_rows
    from repro_torch.kernels import esfk, esmm, estmm
    from repro_torch.quant.core import quantize_blockwise

    tile64 = _esfk_tile64()
    for stage, n, d in ((2, 25088, 384), (3, 6272, 768)):
        f = 4 * d
        x, ri, gen = cs._swin_layout(torch, n, d, seed=8 + stage)
        be, pc, np_rows = ri.block_expert, ri.padded_counts, \
            ri.row_token.numel()
        on = (ri.row_gate != 0)[:, None]

        def randn(*sh, scale=1.0):
            return torch.randn(sh, generator=gen, device="cuda") * scale

        w1, w2 = randn(8, d, f, scale=0.02), randn(8, f, d, scale=0.02)
        b1 = randn(8, f, scale=0.1)
        randn(8, d)                      # b2, as phase 9 draws it
        xs = gather_rows(x, ri.row_token)
        hs, dz, dys = randn(np_rows, f) * on, randn(np_rows, f) * on, \
            randn(np_rows, d) * on
        for x1, x2, what in ((xs, dz, "dW1,db1"), (hs, dys, "dW2,db2")):
            args = (x1, x2, be, pc)
            _timed(f"esfk stage {stage} {what}", lambda: esfk.esfk(*args),
                   lambda: esfk.esfk_plain(*args), cs.SWIN_KERNEL_TOL, flush,
                   root, esfk.esfk, stage=stage)
            for splits in (1, 2, 3, 4, 6, 8) if hasattr(esfk, "_plan") \
                    else ():
                _timed(f"esfk stage {stage} {what} splits {splits}",
                       lambda: esfk._launch(x1, x2, pc, "mma_tf32x3", splits),
                       lambda: esfk.esfk_plain(*args), cs.SWIN_KERNEL_TOL,
                       flush, root, esfk.esfk, stage=stage, splits=splits)
            for splits in (1, 2, 3, 4, 6, 8) if tile64 else ():
                _timed(f"esfk stage {stage} {what} 64-row tiles splits "
                       f"{splits}", _esfk_tile64_call(tile64, x1, x2, pc,
                                                      splits),
                       lambda: esfk.esfk_plain(*args), cs.SWIN_KERNEL_TOL,
                       flush, root, esfk.esfk, stage=stage, splits=splits,
                       tile_rows=64)
            _timed(f"estmm f32 stage {stage} {what[:3]}",
                   lambda: estmm.estmm(*args),
                   lambda: estmm.estmm_plain(*args), cs.GEMM_TOL["float32"],
                   flush, root, estmm.estmm, stage=stage)
        for xa, w, b, trans, what in ((xs, w1, b1, False, "z"),
                                      (dys, w2, None, True, "t"),
                                      (dz, w1, None, True, "dX")):
            _timed(f"esmm f32 stage {stage} {what}",
                   lambda: esmm.esmm(xa, w, b, be, transpose_rhs=trans),
                   lambda: esmm.esmm_plain(xa, w, b, be, transpose_rhs=trans),
                   cs.GEMM_TOL["float32"], flush, root, esmm.esmm,
                   stage=stage)
        del x, xs, hs, dz, dys, w1, w2

    x, ri, _ = cs._sorted_layout(torch, cs.TRAIN_BATCH * cs.TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(21)
    wq, sw = quantize_blockwise(cs._tiled_weights(torch, gen, (128, 2048,
                                                               768)))
    xs = gather_rows(x.bfloat16(), ri.row_token)
    _timed("esmm int8 bf16 xs K 2048 N 768",
           lambda: esmm.esmm(xs, wq, None, ri.block_expert, w_scales=sw),
           lambda: esmm.esmm_plain(xs, wq, None, ri.block_expert,
                                   w_scales=sw),
           cs.GEMM_TOL["bfloat16"], flush, root, esmm.esmm)


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
    build.build(("paged_attention", "esffn", "esmm", "esfk", "estmm"))
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    paged_cases(flush, args.root)
    mlp_cases(flush, args.root)
    gemm_cases(flush, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
