"""The readings a cell's limits are set from, in one process on the chip:

* the program: each seed's compared numbers from a whole run of the cell
  (its window ``--seconds`` long) with every limit lifted;
* the control (the first ``--control-seeds`` seeds): the reference put in
  the program's place at the nearest precision below the configuration's
  ("tf32" for an f32 train cell, "fp8" for a bf16 serve cell), compared
  as the program is;
* for a train cell, the fault "half of the batch left out, the mean over
  the rest", the reference on the first half of each batch in the
  program's place.

    python3 hexabench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 20 [--control-seeds 3]

Prints one JSON line a reading, each with its verdict under the cell's
committed limits (``program_correct``, ``control_correct``,
``half_batch_correct``), then a summary line: each number's largest
program reading and smallest control and fault readings, and every
verdict.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent / "src"))
sys.path.insert(0, str(_HERE.parent))

from hexabench import bench  # noqa: E402


#: The control's precision, one below the configuration's.
CONTROL = {"train": "tf32", "serve": "fp8"}


def _extra(kind, cell, out, limits) -> dict:
    """The control's numbers (and, for a train cell, the half-batch
    fault's), each with its verdict under the committed ``limits``."""
    drv = bench.driver(kind)
    rows = {"control": drv.control_numbers(cell, out, CONTROL[kind])}
    if kind == "train":
        rows["half_batch"] = drv.half_batch_numbers(cell, out)
    got = {}
    for what, numbers in rows.items():
        got[what] = numbers
        got[f"{what}_correct"] = bench.judge(numbers, limits)[0]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    bench.set_cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = []
    for i, seed in enumerate(seeds):
        cell = bench.cell(args.workload, seed=seed, seconds=args.seconds,
                          trace=False, t_start=time.perf_counter())
        limits = cell.limits
        cell.limits = {"limits": {k: float("inf")
                                  for k in limits["limits"]}}
        kind = cell.traffic["kind"]
        out = bench.driver(kind).run(cell)
        program = {k: c["value"] for k, c in out["checks"].items()}
        row = {"seed": seed, "program": program,
               "program_correct": bench.judge(program, limits)[0],
               "e2e": out["e2e"], "failed": out["failed"]}
        if out.get("record"):
            row["program_record"] = out["record"]
        if i < args.control_seeds:
            row.update(_extra(kind, cell, out, limits))
            if out.get("control_record"):
                row["control_record"] = out["control_record"]
        readings.append(row)
        print(json.dumps(row), flush=True)
        del out
    summary = {}
    for k in readings[0]["program"]:
        summary[k] = {"program_max": max(r["program"][k] for r in readings)}
        for what in ("control", "half_batch"):
            vals = [r[what][k] for r in readings if what in r]
            if vals:
                summary[k][f"{what}_min"] = min(vals)
    verdicts = {w: [r[f"{w}_correct"] for r in readings
                    if f"{w}_correct" in r]
                for w in ("program", "control", "half_batch")}
    print(json.dumps({"summary": summary, "verdicts": verdicts,
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
