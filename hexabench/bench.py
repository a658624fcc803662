"""What every run shares: the cell's files found by name, the build and
cache directories, the device, the metric readers, the limits and the
result line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Caches of the port and of the libraries under it, at fixed paths in the
#: checkout (``build/`` is git-ignored), so a cell's second run finds every
#: kernel built. The port's own nvcc libraries go to ``build/kernels``.
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/nv_compute_cache"}


def set_cache_dirs() -> None:
    for var, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


@dataclasses.dataclass
class Cell:
    """One run of one cell: its entries of ``BENCHMARK.json``, its files
    and the run's arguments."""
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"


def port_config(cls, cfg: dict, **extra):
    """The port's config dataclass ``cls`` from a configuration file: its
    fields that the file gives (lists as tuples), plus ``extra``."""
    fields = {f.name for f in dataclasses.fields(cls)} - set(extra)
    return cls(**extra, **{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in cfg.items() if k in fields})


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as fh:
        return json.load(fh)


def cell(name: str, *, seed: int, seconds: float, trace: bool,
         t_start: float, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration file, its
    traffic mix (``traffic/<mix>.json``), its limits
    (``limits/<workload>.json``) and the metrics it reports."""
    from hexabench import traffic as traffic_lib

    b = spec() if benchmark is None else benchmark
    wl = next((w for w in b["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == wl["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    return Cell(
        workload=wl, config=load_json(conf["file"]),
        traffic=traffic_lib.load(wl["traffic"]),
        limits=load_json(f"hexabench/limits/{name}.json"),
        end_to_end=[m for m in b["end_to_end"] if reports(m)],
        per_layer=[m for m in b["per_layer"] if reports(m)],
        seed=seed, seconds=seconds, trace=trace, t_start=t_start)


def reader(metric: str):
    """The ``read(rec)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"hexabench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(metrics: list, rec: dict) -> dict:
    """Each of the cell's per-layer metrics. A metric that ``BENCHMARK.json``
    declares for the cell and whose reader finds nothing to read is a
    fault of the harness: it raises rather than leave the metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(rec)
        if value is None:
            raise RuntimeError(f"per-layer metric {m['name']!r} read nothing "
                               f"in a cell that declares it")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


_MODELS: dict = {}


def model(name: str):
    """``models/<name>.py``: what a train cell needs of the model its
    configuration names; None where there is no such file."""
    path = HERE / "models" / f"{name}.py"
    if not path.is_file():
        return None
    if path not in _MODELS:
        mod_spec = importlib.util.spec_from_file_location(
            f"hexabench.models.{name}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _MODELS[path] = mod
    return _MODELS[path]


def device_info(chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def sync(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    import torch

    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every compared number finite and within its
    limit; ``checks`` maps each name to its number and limit."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits["limits"][name]
        checks[name] = {"value": value, "limit": limit}
        if not (isinstance(value, float) and math.isfinite(value)
                and value <= limit):
            ok = False
    return ok, checks


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: Optional[dict] = None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def report_checks(checks: dict) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()


def driver(kind: str):
    return importlib.import_module(f"hexabench.drivers.{kind}")
