"""Every configuration, mix, limit and metric file loads by name, and a
new one is taken up from new files alone."""
import json
import shutil

import pytest

from hexabench import bench, devtrace, traffic

SPEC = bench.spec()


@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(wl):
    cell = bench.cell(wl, seed=1, seconds=1, trace=False, t_start=0.0)
    assert cell.traffic["kind"] in ("train", "serve")
    assert bench.driver(cell.traffic["kind"]).run
    assert set(cell.limits["limits"])
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_reader_loads(metric):
    read = bench.reader(metric)
    empty = {"window": (0, 1000), "ops": [], "ranges": {},
             "config": {"model": "none", "dtype": "float32"}}
    assert read(empty) is None          # nothing to read: no number


def test_configs_and_mixes_load():
    for c in SPEC["configs"]:
        cfg = bench.load_json(c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert traffic.load(w["traffic"])["name"] == w["traffic"]


def test_new_files_are_taken_up_without_edits(tmp_path, monkeypatch):
    """A new configuration, model, mix, limits file and per-layer metric,
    each a new file, and new entries of BENCHMARK.json: the harness finds
    them by name."""
    root = tmp_path / "repo"
    shutil.copytree(bench.HERE, root / "hexabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = bench.load_json("hexabench/configs/swin_moe_small.json")
    cfg["name"], cfg["model"] = "swin-moe-small-b64", "swin_twice"
    (root / "hexabench/models/swin_twice.py").write_text(
        (bench.HERE / "models/swin.py").read_text()
        + "\n\ndef train_flops(cfg, mix):\n"
        "    return 2 * flops.swin_train_flops(cfg, mix['batch'])\n")
    (root / "hexabench/configs/swin_b64.json").write_text(json.dumps(cfg))
    mix = traffic.load("train.img224.b128")
    mix["batch"] = 64
    (root / "hexabench/traffic/train.img224.b64.json").write_text(
        json.dumps(mix))
    (root / "hexabench/limits/swin_s.train.b64.json").write_text(
        json.dumps(bench.load_json("hexabench/limits/swin_s.train.b128.json")))
    (root / "hexabench/metrics/busy_ms.train.py").write_text(
        "from hexabench import devtrace\n\n\ndef read(rec):\n"
        "    return devtrace.busy_ns(rec) / 1e6 or None\n")
    spec["configs"].append({**spec["configs"][0], "name": cfg["name"],
                            "file": "hexabench/configs/swin_b64.json"})
    spec["workloads"].append({"name": "swin_s.train.b64",
                              "config": cfg["name"],
                              "traffic": "train.img224.b64", "chips": 1,
                              "why": "a later cell"})
    spec["per_layer"].append({"name": "busy_ms.train", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "train_step_ms",
                              "workloads": ["swin_s.train.b64"]})
    spec["end_to_end"][0]["workloads"].append("swin_s.train.b64")
    monkeypatch.setattr(bench, "HERE", root / "hexabench")
    monkeypatch.setattr(bench, "ROOT", root)
    monkeypatch.setattr(traffic, "HERE", root / "hexabench")
    cell = bench.cell("swin_s.train.b64", seed=1, seconds=1, trace=False,
                      t_start=0.0, benchmark=spec)
    assert cell.traffic["batch"] == 64
    assert cell.config["name"] == "swin-moe-small-b64"
    twice = bench.model("swin_twice")
    assert twice.train_flops(cell.config, cell.traffic) == \
        2 * bench.model("swin").train_flops(cell.config, cell.traffic)
    mfu = {"config": cell.config, "traffic": cell.traffic, "step_s": 1.0}
    assert bench.reader("mfu.train")(mfu) == pytest.approx(
        2 * bench.reader("mfu.train")({**mfu, "config": {**cell.config,
                                                          "model": "swin"}}))
    assert [m["name"] for m in cell.per_layer] == ["busy_ms.train"]
    rec = {"window": (0, 1000), "ops": [("k", 100, 600, 50)], "ranges": {}}
    got = bench.read_per_layer(cell.per_layer, rec)
    assert got == {"busy_ms.train": {"value": 0.0005, "unit": "ms"}}
    assert devtrace.busy_ns(rec) == 500


def test_a_declared_metric_that_reads_nothing_fails_the_run():
    declared = [{"name": "decode_step_ms.serve", "unit": "ms"}]
    with pytest.raises(RuntimeError, match="decode_step_ms.serve"):
        bench.read_per_layer(declared, {"decode_times_s": []})


def test_serve_idle_reads_the_unprofiled_steps():
    """Busy 3 s of traced steps that would take 4 s unprofiled (each step
    0.1 s + 1 ms a prefill token + 2 ms a decode row): 25 % idle, however
    long the profiler made them on the host."""
    window = [(0.1 + 1e-3 * p + 2e-3 * d, p, d)
              for p, d in [(0, 32), (256, 31), (100, 32), (256, 32), (40, 30)]]
    traced = [(256, 32), (0, 32), (128, 31)] * 4
    need = sum(0.1 + 1e-3 * p + 2e-3 * d for p, d in traced)
    busy = int(0.75 * need * 1e9)
    rec = {"window": (0, 10 ** 12), "ops": [("k", 0, busy, 0)], "ranges": {},
           "sched_window": window, "sched_traced": traced}
    got = bench.reader("device_idle_pct.serve")(rec)
    assert got == pytest.approx(25.0)
