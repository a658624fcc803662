"""Run one cell of the benchmark once and print its result line.

    python3 hexabench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the device trace of part of the
window). It needs a CUDA device, and as many as the cell's ``chips``;
without them it exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent / "src"))
sys.path.insert(0, str(_HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hexabench import bench, guard

    bench.set_cache_dirs()
    guard.check("at start")
    cell = bench.cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[hexabench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = bench.driver(cell.traffic["kind"]).run(cell)
    guard.check("after the window")
    if cell.trace:
        metrics = bench.read_per_layer(cell.per_layer, out["rec"])
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = bench.device_info(chips)
    device["memory_peak_bytes"] = out["peak"]
    breakdown = None
    if cell.trace:
        device["busy_s"] = out["rec"]["busy_s"]
        device["window_s"] = out["rec"]["window_s"]
        breakdown = out["rec"]["breakdown"]
    line = bench.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"], metrics=metrics, device=device,
        checks=out["checks"], breakdown=breakdown)
    bench.report_checks(out["checks"])
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
