"""The port's train CLI through the fault-tolerant loop, on the CPU
(qwen3-moe-30b-a3b's smoke config in its own bf16).

* A faulted run (a ``train.step`` error at call 3, ``--save-every 2``)
  equals the unfaulted run bit for bit: the per-step losses and the
  step-4 checkpoints' crc32 lists; the restore line is the JAX CLI's.
* 4 steps and then ``--resume`` to 6 equal 6 straight steps bit for bit.
* On 4 gloo ranks (``launch_local``): ``--mesh 2,2 --elastic`` with a
  ``device_drop`` at call 3 (2 survivors) prints the JAX CLI's lines,
  finishes 6 steps on the (2, 1) mesh, and its losses are within the
  mesh-LM tests' 2e-3 of the JAX CLI's elastic run on 4 fake devices
  (one subprocess), which resumes from the port's drawn weights (saved
  at step 0 as a JAX checkpoint, ``--resume``). The same ranks run
  ``--hetero-latencies 1,2 --simulate-skew 3,1 --hetero-replan`` on
  (2, 2) and print the shares the JAX CLI prints. (With ``--simulate-skew
  1,3`` the synthesised times are equal under the plan's (3, 1) shares,
  and neither package replans.)
* ``--metrics`` writes the JAX CLI's series names, the per-expert router
  series included, and ``--events-out`` the JAX CLI's event
  kinds in its order; ``--trace-out``'s spans cover the run.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-30b-a3b"
BASE = ["--arch", ARCH, "--smoke", "--global-batch", "4", "--seq-len", "32",
        "--lr", "1e-2", "--warmup", "3"]
DROP = json.dumps({"faults": [{"site": "train.step", "kind": "device_drop",
                               "at": 3, "payload": {"survivors": 2}}]})
ERROR = json.dumps({"faults": [{"site": "train.step", "kind": "error",
                                "at": 3}]})
ELASTIC = BASE + ["--steps", "6", "--mesh", "2,2", "--elastic",
                  "--save-every", "2", "--fault-spec", DROP]
REPLAN = BASE + ["--steps", "12", "--mesh", "2,2", "--hetero-latencies",
                 "1,2", "--simulate-skew", "3,1", "--hetero-replan"]
LOSS_RTOL = 2e-3
ELASTIC_LINES = ["[elastic] device loss -> re-mesh (2, 1) over 2 survivors",
                 "[ft] resumed on shrunken mesh at step 2",
                 "[train] finished at step 6"]


def _port(argv):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = train.main(argv + ["--device", "cpu"])
    return log, buf.getvalue()


def _by_step(log):
    """The last loss logged for each step (a replayed step logs twice)."""
    return {m["step"]: m["loss"] for m in log}


def _crcs(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["crc32"]


def _obs_off():
    from repro_torch import obs

    obs.configure(metrics=False, tracing=False, event_log=False, reset=True)


def test_faulted_run_equals_unfaulted_run(tmp_path):
    a = str(tmp_path / "a")
    b = str(tmp_path / "b")
    log_a, _ = _port(BASE + ["--steps", "4", "--save-every", "4",
                             "--ckpt-dir", a])
    log_b, out_b = _port(BASE + ["--steps", "4", "--save-every", "2",
                                 "--ckpt-dir", b, "--fault-spec", ERROR])
    assert [m["step"] for m in log_b] == [1, 2, 3, 3, 4]
    assert _by_step(log_a) == _by_step(log_b)
    assert log_b[2]["loss"] == log_b[3]["loss"]
    assert _crcs(a, 4) == _crcs(b, 4)
    assert "[ft] step failure (FaultError('injected fault at train.step " \
           "(call 3)')); restored step 2 (ckpt 2), 1 failures in window, " \
           "backoff 0.058s" in out_b
    assert "[train] finished at step 4" in out_b


def test_resume_equals_straight_run(tmp_path):
    a = str(tmp_path / "a")
    b = str(tmp_path / "b")
    log_a, _ = _port(BASE + ["--steps", "6", "--save-every", "2",
                             "--ckpt-dir", a])
    _port(BASE + ["--steps", "4", "--save-every", "2", "--ckpt-dir", b])
    log_b, out = _port(BASE + ["--steps", "6", "--save-every", "2",
                               "--ckpt-dir", b, "--resume"])
    assert "[train] resumed from step 4" in out
    assert [m["step"] for m in log_b] == [5, 6]
    assert _by_step(log_b) == {k: v for k, v in _by_step(log_a).items()
                               if k > 4}
    assert _crcs(a, 6) == _crcs(b, 6)


def _mesh_rank(rank, tmp):
    _obs_off()
    paths = {k: os.path.join(tmp, f"{k}{rank}") for k in
             ("metrics", "trace", "events")}
    elastic = _port(ELASTIC + ["--ckpt-dir", os.path.join(tmp, "ck"),
                               "--metrics", paths["metrics"],
                               "--trace-out", paths["trace"],
                               "--events-out", paths["events"]])
    replan = _port(REPLAN + ["--ckpt-dir", os.path.join(tmp, "ck_rp"),
                             "--events-out", paths["events"] + "rp"])
    return [m["loss"] for m in elastic[0]], elastic[1], replan[1]


JAX_SCRIPT = r"""
import contextlib, io, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as cfglib
from repro.checkpoint import manager as ckpt
from repro.launch import train
from repro.models import lm
from repro.optim import adamw
from repro.parallel.sharding import split_tree

tmp, elastic, replan = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
data = np.load(tmp + "/w.npz")
cfg = cfglib.get_smoke_config("%(arch)s")
shapes, _ = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
leaves = []
for path, ref in jax.tree_util.tree_flatten_with_path(shapes)[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path)
    leaves.append(jnp.asarray(data[key]).astype(ref.dtype))
params = jax.tree.unflatten(jax.tree.structure(shapes), leaves)
opt = adamw.init_opt_state(params, adamw.OptimizerConfig(master_fp32=True))
ckpt.save(tmp + "/jck", 0, {"params": params, "opt": opt}, meta={"step": 0})
out = {}
for name, argv in (("elastic", elastic + ["--resume"]), ("replan", replan)):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = train.main(argv)
    out[name] = [[m["step"], m["loss"]] for m in log], buf.getvalue()
print("RESULT" + json.dumps(out))
""" % dict(arch=ARCH)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from repro_torch import configs as cfglib
    from repro_torch.models import lm
    from test_torch_mesh_cli import _jax_layout

    tmp = str(tmp_path_factory.mktemp("train_ft_mesh"))
    cfg = cfglib.get_smoke_config(ARCH)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    np.savez(os.path.join(tmp, "w.npz"), **_jax_layout(params, cfg))
    jargs = {k: os.path.join(tmp, "j" + k) for k in
             ("metrics", "trace", "events")}
    elastic = ELASTIC + ["--ckpt-dir", os.path.join(tmp, "jck"),
                         "--metrics", jargs["metrics"],
                         "--trace-out", jargs["trace"],
                         "--events-out", jargs["events"]]
    replan = REPLAN + ["--ckpt-dir", os.path.join(tmp, "jck_rp"),
                       "--events-out", jargs["events"] + "rp"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, tmp, json.dumps(elastic),
         json.dumps(replan)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        ranks = launch_local(_mesh_rank, 4, tmp, timeout=300)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    line = [x for x in stdout.splitlines() if x.startswith("RESULT")][-1]
    return tmp, json.loads(line[len("RESULT"):]), ranks


def test_elastic_shrink_on_four_ranks_matches_the_jax_cli(mesh_runs):
    _, jax_out, ranks = mesh_runs
    jlog, jprinted = jax_out["elastic"]
    losses, printed, _ = ranks[0]
    for text in (printed, jprinted):
        for want in ELASTIC_LINES:
            assert want in text, (want, text)
        assert "restored step 2 (ckpt 2)" in text
    assert "[train] resumed from step 0" in jprinted
    assert [s for s, _ in jlog] == [1, 2, 3, 3, 4, 5, 6]
    assert len(losses) == 7 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, [v for _, v in jlog],
                               rtol=LOSS_RTOL)
    # rank 1 survives with rank 0; ranks 2 and 3 leave after step 3
    assert ranks[1][0] == losses
    for r in ranks[2:]:
        assert r[0] == losses[:3] and r[1] == ""


def test_replan_prints_the_jax_clis_shares(mesh_runs):
    _, jax_out, ranks = mesh_runs
    pat = r"\[hetero\] replan -> shares \[.*?\]"
    got = re.findall(pat, ranks[0][2])
    assert got and got == re.findall(pat, jax_out["replan"][1])
    assert "token_counts=(3, 1)" in ranks[0][2]


def test_obs_outputs_match_the_jax_cli(mesh_runs):
    from repro_torch import obs

    tmp, _, _ = mesh_runs

    def names(path):
        with open(path) as f:
            return sorted({re.sub(r"(_bucket|_sum|_count)?[{ ].*", "", x)
                           for x in f.read().splitlines()
                           if x and not x.startswith("#")})

    def kinds(path):
        with open(path) as f:
            return [json.loads(x)["kind"] for x in f if x.strip()]

    # every family, the per-expert router series too
    jnames = names(os.path.join(tmp, "jmetrics"))
    assert names(os.path.join(tmp, "metrics0")) == jnames
    assert "repro_ft_recoveries_total" in jnames
    assert "repro_router_expert_tokens_total" in jnames
    assert kinds(os.path.join(tmp, "events0")) == \
        kinds(os.path.join(tmp, "jevents")) == ["train.shrink",
                                                "train.recover"]
    assert kinds(os.path.join(tmp, "events0rp")) == \
        kinds(os.path.join(tmp, "jeventsrp"))
    assert "train.replan" in kinds(os.path.join(tmp, "events0rp"))
    assert not os.path.exists(os.path.join(tmp, "metrics1"))  # rank 0 only
    with open(os.path.join(tmp, "trace0")) as f:
        trace = json.load(f)
    spans = {e["name"] for e in trace["traceEvents"]}
    assert {"train.run", "train.step", "train.data", "train.remesh",
            "ckpt.snapshot", "ckpt.restore"} <= spans
    assert obs.chrome_span_coverage(trace) > 0.99
