#!/usr/bin/env python3
"""Where a Swin-MoE training step of the PyTorch port spends its time, on
one NVIDIA GPU.

    python3 scripts/torch_swin_profile.py [--batch 128] [--steps 3]
        [--config small|base] [--moe-impl hexa|tutel|megablocks]
        [--top-k K] [--unfused]
        [--mode hybrid|model_centric|data_centric|auto|ep]
        [--cache-policy shared_cache|janus|none]

Builds Swin-MoE-Small or -Base (``configs/swin_moe_small.py``,
``configs/swin_moe_base.py``: 8 experts, top-1 unless ``--top-k``, f32)
at full width and depth with AdamW (``master_fp32=False``, as the JAX
package's ``benchmarks/memory_table.py`` step), its MoE blocks through
``--moe-impl`` (the paper's method, or the Tutel or MegaBlocks baseline),
with the unfused expert backward (ESTMM + ESS, the Fig. 12 ablation)
under ``--unfused``. With ``--mode`` the step runs on a 1-rank mesh
(chip_smoke.py's phase M): a 1-rank NCCL group on the card,
``make_mesh((1, 1, 1), ("pod", "data", "model"))``, the parameters as the
mode shards them and ``--cache-policy`` for the gathered expert weights;
one rank moves nothing across chips, so what differs from the mesh-less
step is the gathers' copies, the recompute and the collectives' own
launches (``train_step.grad_sync`` is the gradient sum and the sharded
clip norm). It takes one warm-up
step on seeded 224^2 images and labels (blk 128), times ``--steps`` train
steps on the host clock, then runs as many again under ``torch.profiler``
and prints, as JSON lines (``scripts/torch_train_profile.report``): the
step's wall time (unprofiled) and images/s, the device busy time a step,
the idle share ``1 - busy / wall``, the device time of the optimizer
update (the ``train_step.adamw`` range), device time and launches a step
by kind of work (the expert kernels by name), then the top 30 kernels.
The card's name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import swin_moe_base, swin_moe_small  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import swin  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402
from torch_train_profile import report  # noqa: E402

# Kernel name fragments -> kind of work, first match wins.
KINDS = (
    ("esffn_mlp", "esffn_mlp (fused MLP expert FFN, forward)"),
    ("esfk", "esfk (expert dW and db)"),
    ("ess_kernel", "ess (expert db, unfused backward)"),
    ("estmm", "estmm (expert dW, unfused backward)"),
    ("esmm", "esmm (expert z recompute, t, dX)"),
    ("gemm", "cuBLAS matmuls (attention, dense MLPs, patch, merge, head;"
             " the baselines' expert GEMMs)"),
    ("gemv", "cuBLAS matmuls (attention, dense MLPs, patch, merge, head)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("index", "gathers, scatters, index_add"),
    ("scatter", "gathers, scatters, index_add"),
    ("gather", "gathers, scatters, index_add"),
    ("sort", "routing sort and re-index"),
    ("Sort", "routing sort and re-index"),
    ("reduce", "reductions (layer norms, softmax, grad norm)"),
    ("softmax", "reductions (layer norms, softmax, grad norm)"),
    ("elementwise", "elementwise (AdamW, gelu, residuals, rolls, casts)"),
    ("vectorized", "elementwise (AdamW, gelu, residuals, rolls, casts)"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", choices=("small", "base"), default="small")
    ap.add_argument("--moe-impl", choices=("hexa", "tutel", "megablocks"),
                    default="hexa")
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--unfused", action="store_true",
                    help="the unfused expert backward (ESTMM + ESS)")
    ap.add_argument("--mode", choices=("hybrid", "model_centric",
                                       "data_centric", "auto", "ep"),
                    help="run the step on a 1-rank mesh in this mode")
    ap.add_argument("--cache-policy", default="shared_cache",
                    choices=("shared_cache", "janus", "none"),
                    help="with --mode: what the backward keeps of the "
                         "gathered expert weights")
    args = ap.parse_args(argv)
    if args.mode is None and args.cache_policy != "shared_cache":
        ap.error("--cache-policy needs --mode")
    if args.mode is not None and args.moe_impl != "hexa":
        ap.error("--mode runs the hexa islands only")
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build()
    base = {"small": swin_moe_small, "base": swin_moe_base}[args.config]
    cfg = swin_moe_small.with_experts(base.CONFIG, 8, args.top_k)
    opt_cfg = adamw.OptimizerConfig(master_fp32=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = swin.init_swin(cfg, generator=gen, device="cuda")
    batches = [swin.synthetic_batch(cfg, args.batch, generator=gen,
                                    device="cuda")
               for _ in range(2 * args.steps + 1)]
    with contextlib.ExitStack() as stack:
        mesh = None
        if args.mode is None:
            pcfg = ParallelConfig(blk=128)
        else:
            from repro_torch.launch.mesh import make_mesh, single_rank_nccl
            from repro_torch.parallel.sharding import shard_tree

            stack.enter_context(single_rank_nccl())
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
            pcfg = ParallelConfig(blk=128, mode=args.mode,
                                  cache_policy=args.cache_policy,
                                  capacity_factor=8.0)
            params = shard_tree(params, swin.param_specs(cfg, pcfg), pcfg,
                                mesh)
        opt_state = adamw.init_opt_state(params, opt_cfg)
        train_step = swin.make_train_step(cfg, pcfg, opt_cfg,
                                          moe_impl=args.moe_impl, mesh=mesh)
        ops.set_fused_backward(not args.unfused)
        return _profile(args, cfg, params, opt_state, batches, train_step)


def _profile(args, cfg, params, opt_state, batches, train_step) -> int:

    def run(i):
        _, _, m = train_step(params, opt_state, *batches[i])
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
                  {"config": cfg.name, "top_k": args.top_k,
                   "moe_impl": args.moe_impl, "mesh_mode": args.mode,
                   "cache_policy": args.cache_policy if args.mode else None,
                   "fused_backward": not args.unfused, "images": args.batch,
                   "train_step_wall_ms": wall * 1e3,
                   "images_per_s": args.batch / wall})


if __name__ == "__main__":
    sys.exit(main())
