"""The port's train and serve CLIs on a mesh.

Four gloo ranks on the CPU (``launch.mesh.launch_local``) each call the
CLI's ``main(argv)`` with ``--mesh 2,2 --device cpu`` (the group is
``launch_local``'s; ``launch.mesh.cli_process_group`` takes it as it is),
on qwen3-moe-30b-a3b's smoke config in its own bf16:

* the train CLI in each ``--mode`` (``--cache-policy janus`` and
  ``--schedule ag_ar`` once each): its per-step losses are those of the
  same step built in the rank (``train.build_state``,
  ``steps.make_train_step`` on the mesh, the batches cut by
  ``inputs.batch_block``), bit for bit;
* ``--hetero-latencies 1,2 --hetero-tp-latencies 1,2``: the printed plan's
  ``token_counts`` and ``hidden_splits`` are those of JAX's
  ``make_hetero_plan``, and the three losses are within 2e-3 relative of
  JAX's train step under the same plan on a (2, 2) mesh of fake devices
  (one subprocess), from the same weights (the CLI's seeded draw, padded
  by the plan) and the same packed batches (the limit of the bf16 train
  step in ``tests/test_torch_train.py``; measured 1.5e-5, 2.4e-4 and
  1.3e-3: bf16 rounding, grown by two updates at lr 1e-2);
* the serve CLI with ``--mesh 2,2 --cache-layers 2``: the greedy streams
  of the mesh-less serve CLI, and the prefetch cache's line;
* the flag errors: what JAX's train CLI refuses with an argparse error
  the port's refuses too, and a mesh of several ranks in one process
  raises naming ``torchrun``; ``--mesh 1,1`` runs in one process, the
  paged engine's streams (``--paged --prefix-cache --disagg``) those of
  the mesh-less paged engine.
"""
import contextlib
import io
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
BASE = ["--arch", ARCH, "--smoke", "--steps", "3", "--global-batch", "4",
        "--seq-len", "32", "--device", "cpu", "--lr", "1e-2", "--warmup",
        "1"]
RUNS = [("hybrid", ["--mode", "hybrid"]),
        ("hybrid-ag_ar", ["--mode", "hybrid", "--schedule", "ag_ar"]),
        ("model_centric", ["--mode", "model_centric"]),
        ("data_centric", ["--mode", "data_centric"]),
        ("data_centric-janus", ["--mode", "data_centric", "--cache-policy",
                                "janus"]),
        ("auto", ["--mode", "auto", "--proxy-latencies", "1.0,1.5"]),
        ("ep", ["--mode", "ep"]),
        ("hybrid-cache", ["--mode", "hybrid", "--cache-layers", "2"])]
HETERO = ["--mode", "hybrid", "--hetero-latencies", "1,2",
          "--hetero-tp-latencies", "1,2"]
SERVE = ["--arch", ARCH, "--smoke", "--slots", "4", "--max-seq", "32",
         "--requests", "5", "--max-new", "4", "--device", "cpu"]
HETERO_RTOL = 2e-3


def _plan():
    from repro_torch.core.hetero import make_hetero_plan

    return make_hetero_plan((1.0, 2.0), global_batch=4, hidden_size=32,
                            tp_latencies=(1.0, 2.0))


def _in_process_losses(extra):
    """The losses of the CLI's step built here: its state, step and
    batches through the port's API."""
    from repro_torch import configs as cfglib
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps
    from repro_torch.launch import train
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    flags = dict(zip(extra[::2], extra[1::2]))
    cfg = cfglib.get_smoke_config(ARCH)
    lat = flags.get("--proxy-latencies")
    pcfg = ParallelConfig(
        blk=16, mode=flags["--mode"],
        collective_schedule=flags.get("--schedule", "ag_rs"),
        cache_policy=flags.get("--cache-policy", "shared_cache"),
        cache_layers=int(flags.get("--cache-layers", 0)),
        device_latencies=None if lat is None else tuple(
            float(t) for t in lat.split(",")))
    mesh = make_mesh((2, 2), ("data", "model"))
    opt_cfg = adamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                                    decay_steps=3, master_fp32=True)
    params, state = train.build_state(cfg, opt_cfg, 0, torch.device("cpu"),
                                      pcfg=pcfg, mesh=mesh)
    shape3 = (4, 32, cfg.d_model)
    step = steps.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh,
                                 batch_shape3=shape3)
    src = TokenSource(DataConfig(seq_len=32, global_batch=4,
                                 vocab_size=cfg.vocab_size, seed=0))
    x_spec = activation_spec(shape3, pcfg, mesh)
    out = []
    for i in range(3):
        batch = train.batch_to(batch_block(src.batch(i), x_spec, mesh),
                               "cpu")
        params, state, m = step(params, state, batch)
        out.append(float(m["loss"]))
    return out


def _cli_rank(rank):
    from repro_torch.launch import serve, train

    out = {}
    for name, extra in RUNS:
        log = train.main(BASE + ["--mesh", "2,2"] + extra)
        out[name] = ([m["loss"] for m in log], _in_process_losses(extra))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = train.main(BASE + ["--mesh", "2,2"] + HETERO)
    out["hetero"] = ([m["loss"] for m in log], buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = serve.main(SERVE + ["--mesh", "2,2", "--cache-layers", "2"])
    out["serve_mesh"] = ({r.rid: list(r.out) for r in done}, buf.getvalue())
    done = serve.main(SERVE)
    out["serve_plain"] = {r.rid: list(r.out) for r in done}
    return out


JAX_SCRIPT = r"""
import sys, json
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as cfglib
from repro.core.hetero import make_hetero_plan, pack_batch
from repro.data.pipeline import DataConfig, TokenSource
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.optim import adamw
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings

data = np.load(sys.argv[1])
cfg = cfglib.get_smoke_config("%(arch)s")
plan = make_hetero_plan((1.0, 2.0), global_batch=4, hidden_size=32,
                        tp_latencies=(1.0, 2.0))
shapes, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg,
                                          plan=plan))
leaves = []
for path, ref in jax.tree_util.tree_flatten_with_path(shapes)[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path)
    leaves.append(jnp.asarray(data[key]).astype(ref.dtype))
params = jax.tree.unflatten(jax.tree.structure(shapes), leaves)
mesh = make_mesh((2, 2), ("data", "model"))
pcfg = ParallelConfig(mode="hybrid", blk=16, hetero_plan=plan)
opt_cfg = adamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=3,
                                master_fp32=True)
src = TokenSource(DataConfig(seq_len=32, global_batch=4,
                             vocab_size=cfg.vocab_size, seed=0))
eff = len(plan.token_counts) * plan.batch_capacity
losses = []
with mesh:
    params = jax.tree.map(jax.device_put, params,
                          tree_shardings(params, specs, pcfg, mesh))
    state = adamw.init_opt_state(params, opt_cfg)
    step = jax.jit(steps_lib.make_train_step(cfg, pcfg, mesh, opt_cfg,
                                             (eff, 32, cfg.d_model)))
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in pack_batch(
            {k: np.asarray(v) for k, v in src.batch(i).items()}, plan).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
print("RESULT" + json.dumps({"losses": losses,
                             "token_counts": list(plan.token_counts),
                             "hidden_splits": list(plan.hidden_splits)}))
""" % dict(arch=ARCH)


def _jax_layout(tree, cfg):
    """The JAX tree's leaves (layers stacked per period position) from the
    port's, keyed by path, in f32."""
    from repro_torch.common import tree_map

    period = cfg.period
    out = {}

    def put(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                put(f"{prefix}{k}/", v)
        else:
            out[prefix[:-1]] = node.float().numpy()

    stacked = [tree_map(lambda *xs: torch.stack(xs), *tree["layers"][pos::period])
               for pos in range(period)]
    put("", {**{k: v for k, v in tree.items() if k != "layers"},
             "layers": {str(i): s for i, s in enumerate(stacked)}})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json

    from repro_torch import configs as cfglib
    from repro_torch.models import lm

    tmp = tmp_path_factory.mktemp("mesh_cli")
    cfg = cfglib.get_smoke_config(ARCH)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", plan=_plan())
    np.savez(tmp / "w.npz", **_jax_layout(params, cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                             str(tmp / "w.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = launch_local(_cli_rank, 4, timeout=300)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    line = [x for x in stdout.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):]), ranks


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_train_cli_on_mesh_is_the_in_process_step(results, name):
    _, ranks = results
    for r in ranks:
        cli, ref = r[name]
        assert len(cli) == 3 and np.isfinite(cli).all()
        assert cli == ref, (name, cli, ref)
    # every rank reports the same (global) loss
    assert len({tuple(r[name][0]) for r in ranks}) == 1


def test_train_cli_hetero_plan_and_losses_match_jax(results):
    jax_out, ranks = results
    losses, printed = ranks[0]["hetero"]
    m = re.search(r"token_counts=\((.*?)\).*hidden_splits=\((.*?)\)",
                  printed)
    assert m, printed
    counts = [int(t) for t in m.group(1).split(",") if t.strip()]
    splits = [int(t) for t in m.group(2).split(",") if t.strip()]
    assert counts == jax_out["token_counts"]
    assert splits == jax_out["hidden_splits"]
    np.testing.assert_allclose(losses, jax_out["losses"], rtol=HETERO_RTOL)
    for r in ranks[1:]:
        assert r["hetero"][1] == ""        # only rank 0 prints
        assert r["hetero"][0] == losses


def test_serve_cli_on_mesh_with_prefetch_cache(results):
    _, ranks = results
    for r in ranks:
        toks, _ = r["serve_mesh"]
        assert toks == r["serve_plain"]
        assert len(toks) == 5 and all(len(t) == 4 for t in toks.values())
    printed = ranks[0]["serve_mesh"][1]
    assert "[serve] 5 requests, 20 tokens" in printed
    assert "a rank (4 slots" in printed
    m = re.search(r"prefetch cache \(last forward\): (\d+) peak resident "
                  r"layers.*?(\d+) hits", printed)
    assert m and int(m.group(1)) <= 2 and int(m.group(2)) > 0, printed


@pytest.mark.parametrize("extra", [
    ["--hetero-latencies", "1,2"],
    ["--proxy-latencies", "1,x"],
    ["--proxy-latencies", "1,-2"],
    ["--mode", "bogus"],
], ids=["hetero-without-mesh", "latency-not-a-number", "latency-negative",
        "unknown-mode"])
def test_train_cli_flag_errors_match_jax(extra):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    argv = ["--arch", ARCH, "--smoke", "--steps", "1"] + extra
    with pytest.raises(SystemExit) as jerr:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as terr:
        ttrain.main(argv + ["--device", "cpu"])
    assert jerr.value.code == terr.value.code == 2


def test_cli_mesh_errors_and_one_rank_mesh():
    from repro_torch.launch import serve, train

    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--device",
                    "cpu", "--mesh", "2,2"])
    with pytest.raises(SystemExit):
        serve.main(SERVE + ["--mesh", "1,1", "--quant", "int8"])
    # the paged engine on a 1-rank mesh streams what it streams without
    paged = ["--paged", "--page-size", "4", "--prefix-cache", "--disagg"]
    on_mesh = serve.main(SERVE + ["--mesh", "1,1"] + paged)
    plain = serve.main(SERVE + paged)
    assert {r.rid: r.out for r in on_mesh} == {r.rid: r.out for r in plain}
    assert len(on_mesh) == 5 and all(len(r.out) == 4 for r in on_mesh)
    log = train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                      "--global-batch", "2", "--seq-len", "16", "--device",
                      "cpu", "--mesh", "1,1,1", "--mode", "data_centric"])
    plain = train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                        "--global-batch", "2", "--seq-len", "16",
                        "--device", "cpu"])
    assert abs(log[0]["loss"] - plain[0]["loss"]) <= 2e-3 * plain[0]["loss"]
