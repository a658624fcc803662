"""The result line, the run without a card, and the import guard."""
import json
import os
import shutil
import subprocess
import sys

from hexabench import bench, guard

ROOT = bench.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_has_the_contract_keys():
    checks = {"loss_gap": {"value": 1e-7, "limit": 1e-5}}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    line = json.loads(bench.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}}, device=dev,
        checks=checks))
    assert list(line) == KEYS + ["checks"]       # the compared numbers last
    traced = json.loads(bench.result_line(
        correct=True, attempted=3, failed=0, metrics={}, device=dev,
        checks=checks, breakdown={"device_ops": [], "idle_gaps": []}))
    assert list(traced) == KEYS + ["breakdown", "checks"]
    assert bench.judge({"loss_gap": 2e-5}, {"limits": {"loss_gap": 1e-5}})[0] \
        is False
    assert bench.judge({"loss_gap": float("nan")},
                       {"limits": {"loss_gap": 1.0}})[0] is False


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "hexabench/run.py", "--workload", "swin_s.train.b128",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hexabench", tmp_path / "hexabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden(["repro_torch", "repro_torch.models",
                                   "torch", "jaxtyping"]) == []
    assert guard.loaded_forbidden(["repro.models.lm", "jax.numpy",
                                   "flax"]) == ["flax", "jax", "repro"]


def test_references_load_nothing_of_the_program():
    assert guard.reference_violations() == []


def test_harness_and_port_load_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import hexabench.drivers.train, hexabench.drivers.serve\n"
        "import hexabench.calibrate, hexabench.devtrace\n"
        "from hexabench.reference import swin, mixtral\n"
        "import repro_torch.models.swin, repro_torch.launch.serve\n"
        "from hexabench import guard, bench\n"
        "for m in bench.spec()['per_layer']: bench.reader(m['name'])\n"
        "print(guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    ref_only = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from hexabench.reference import swin, mixtral, adamw, precision\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", ref_only],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
