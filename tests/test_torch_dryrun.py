"""PyTorch port vs the JAX package: the meta-device dry run and the
abstract inputs (``launch.dryrun``, ``launch.inputs``).

One JAX subprocess over 8 fake CPU devices builds each LM arch's abstract
parameter tree (``steps.sharded_params`` on a (2, 2, 2) ("pod", "data",
"model") mesh, hybrid; nothing compiled) and reports its element count
and the bytes of one device's shards (``sharding.shard_shape``), and the
placement of the abstract inputs. The port must give:

* ``params_total`` and ``params_active`` equal to JAX's count (active:
  JAX's dry run formula) for every arch at full width;
* rank 0's shard bytes of the meta parameters on a (2, 2, 2) fake-backend
  mesh equal to JAX's shard bytes;
* ``input_specs`` and ``cache_specs`` of the JAX package's shapes and
  dtypes (the cache's layers one a layer, JAX's stacked by period), and
  the batch placed over the data axes as JAX places it;
* a full-width cell (qwen3-moe-30b-a3b, ``train_4k``, 2 layers) on 512
  fake ranks, the multi-pod mesh (2, 16, 16), in a subprocess: status ok,
  every collective kind counted, and the process's peak resident memory
  under 1.5 GB, where the cell's global state is ~26 GB (nothing
  allocated);
* error rows with their reason, never zeros.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import inputs as jinputs
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch import configs as tcfglib
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.parallel.sharding import ParallelConfig as TPC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in tcfglib.ARCHS if not a.startswith("swin")]

JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro import configs as cfglib
from repro.common import tree_params
from repro.configs.base import SHAPES
from repro.launch import inputs as inputs_lib
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_mesh
from repro.parallel.sharding import ParallelConfig

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
pcfg = ParallelConfig(mode="hybrid", remat="block", blk=128, impl="blocked",
                      scan_layers=True)
out = {"params": {}, "inputs": {}}
for arch in json.loads(sys.argv[1]):
    cfg = cfglib.get_config(arch)
    ap, _, _ = steps_lib.sharded_params(cfg, pcfg, mesh)
    leaves = jax.tree_util.tree_leaves(ap)
    out["params"][arch] = [tree_params(ap), sum(
        int(np.prod(l.sharding.shard_shape(l.shape))) * l.dtype.itemsize
        for l in leaves)]
for arch in ("qwen3-moe-30b-a3b", "paligemma-3b"):
    for shape in ("train_4k", "decode_32k"):
        specs = inputs_lib.input_specs(cfglib.get_config(arch),
                                       SHAPES[shape], pcfg, mesh)
        out["inputs"][arch + "/" + shape] = {
            k: [list(v.shape), str(v.dtype),
                [list(e) if isinstance(e, tuple) else e
                 for e in v.sharding.spec][:1]]
            for k, v in specs.items()}
print("RESULT" + json.dumps(out))
"""


def _run(code_or_args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    res = subprocess.run([sys.executable] + code_or_args,
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, res.stdout[-2000:]
    return json.loads(line[-1][len("RESULT"):])


@pytest.fixture(scope="module")
def jax_abstract():
    return _run(["-c", JAX_SCRIPT, json.dumps(LM_ARCHS)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})


PORT_SCRIPT = r"""
import json, sys
import torch
from repro_torch import configs as cfglib
from repro_torch.common import tree_leaves
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.sharding import ParallelConfig

out = {}
with dryrun.fake_world(8):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    for arch in json.loads(sys.argv[1]):
        cfg = cfglib.get_config(arch)
        p, _ = steps.sharded_params(cfg, ParallelConfig(mode="hybrid"), mesh,
                                    generator=torch.Generator(),
                                    device="meta")
        out[arch] = [*dryrun.param_counts(cfg), sum(
            t.numel() * t.element_size() for t in tree_leaves(p))]
print("RESULT" + json.dumps(out))
"""


def test_param_counts_and_shard_bytes_equal_jax(jax_abstract):
    port = _run(["-c", PORT_SCRIPT, json.dumps(LM_ARCHS)])
    for arch in LM_ARCHS:
        total, sbytes = jax_abstract["params"][arch]
        p_total, p_active, p_bytes = port[arch]
        cfg = jcfglib.get_config(arch)
        active = total
        if cfg.moe is not None:
            n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
            active -= (n_moe * (cfg.moe.num_experts - cfg.moe.top_k)
                       * (3 if cfg.glu else 2) * cfg.d_model * cfg.moe.d_ff)
        assert (p_total, p_active, p_bytes) == (total, active, sbytes), arch


class _Grid:
    """A mesh's shape without a process group (all the specs need)."""

    def __init__(self, dims, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, dims))

    def size(self, axes):
        from repro_torch.parallel.sharding import as_axes

        return int(np.prod([self.shape[a] for a in as_axes(axes)]))


def test_input_specs_equal_jax(jax_abstract):
    grid = _Grid((2, 2, 2), ("pod", "data", "model"))
    for key, want in jax_abstract["inputs"].items():
        arch, shape = key.split("/")
        got = tinputs.input_specs(tcfglib.get_config(arch), TSHAPES[shape],
                                  TPC(mode="hybrid"), grid)
        assert list(got) == list(want), key
        for k, ts in got.items():
            shp, dtype, (batch_entry,) = want[k]
            assert list(ts.shape) == shp and str(ts.dtype) == \
                f"torch.{dtype}", (key, k)
            entry = ts.spec[0]
            assert (list(entry) if isinstance(entry, tuple) else entry) \
                == batch_entry, (key, k, ts.spec)
            assert all(e is None for e in ts.spec[1:]), (key, k)
            local = ts.local_shape(grid)
            assert local[0] == shp[0] // (4 if batch_entry else 1)
            assert ts.meta(grid).shape == local


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                                  "xlstm-350m", "gemma3-12b"])
def test_cache_specs_equal_jax_shapes(arch):
    cj = jcfglib.get_smoke_config(arch)
    ct = tcfglib.get_smoke_config(arch)
    shape = dataclasses.replace(JSHAPES["decode_32k"], seq_len=64,
                                global_batch=4)
    tshape = dataclasses.replace(TSHAPES["decode_32k"], seq_len=64,
                                 global_batch=4)
    want = jinputs.cache_specs(cj, shape, JPC(), None)
    got = tinputs.cache_specs(ct, tshape, TPC(), None)
    n_periods = ct.num_layers // ct.period
    assert len(got["layers"]) == ct.num_layers
    for i, layer in enumerate(got["layers"]):
        wl = want["layers"][i % ct.period]
        assert set(layer) == set(wl), i
        for k, ts in layer.items():
            assert (n_periods,) + ts.shape == tuple(wl[k].shape), (i, k)
            assert str(ts.dtype) == f"torch.{wl[k].dtype}", (i, k)
    assert got["len"].shape == tuple(want["len"].shape)
    grid = _Grid((2, 2), ("data", "model"))
    placed = tinputs.cache_specs(ct, tshape, TPC(), grid)
    assert placed["len"].spec == ("data",)
    assert all(ts.spec[0] == "data" for layer in placed["layers"]
               for ts in layer.values())


def test_concrete_inputs_equal_jax():
    from repro.launch.inputs import concrete_inputs as jconcrete

    for arch in ("qwen3-moe-30b-a3b", "paligemma-3b", "musicgen-large"):
        shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=24,
                                    global_batch=2)
        tshape = dataclasses.replace(TSHAPES["train_4k"], seq_len=24,
                                     global_batch=2)
        want = jconcrete(jcfglib.get_smoke_config(arch), shape, seed=5)
        got = tinputs.concrete_inputs(tcfglib.get_smoke_config(arch),
                                      tshape, seed=5, device="cpu")
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


CELL_SCRIPT = r"""
import json
from repro_torch.launch import dryrun
row = dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k",
                   "--multi-pod", "--layers-override", "2"])
# this process's peak resident set (VmHWM: its own address space, where
# getrusage's maximum also holds the forking parent's)
with open("/proc/self/status") as f:
    kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmHWM:"))
row["maxrss_bytes"] = kb * 1024
print("RESULT" + json.dumps(row))
"""


def test_full_width_cell_on_512_fake_ranks_allocates_nothing():
    row = _run(["-c", CELL_SCRIPT])
    assert row["status"] == "ok", row
    assert row["chips"] == 512
    assert row["mesh"] == {"pod": 2, "data": 16, "model": 16}
    cfg = tcfglib.get_config("qwen3-moe-30b-a3b")
    assert (row["params_total"], row["params_active"]) == \
        dryrun.param_counts(dataclasses.replace(cfg, num_layers=2))
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
        set(row["collectives"])
    assert all(v["count"] > 0 and v["bytes"] > 0
               for v in row["collectives"].values())
    # the cell's global parameters and AdamW state (bf16 weights, f32
    # master and moments: 14 bytes a parameter) would need ~26 GB; the
    # process held ~0.3 GB
    assert row["params_total"] * 14 > 20e9
    assert row["maxrss_bytes"] < 1.5e9
    assert row["memory"]["argument_bytes"] > 0
    assert "the step's temporaries" in row["memory"]["not_counted"]
    assert row["flops_per_device"] > 0
    assert row["roofline"]["hardware"].startswith("H100")


def test_error_rows_name_their_reason(monkeypatch):
    args = dryrun.argparse.Namespace(
        devices=8, mesh_shape="2,2,2", mode="hybrid", schedule="ag_rs",
        cache_policy="shared_cache", layers_override=2)
    skipped = dryrun.run_cell("qwen3-moe-30b-a3b", "long_500k", False, args)
    assert skipped["status"] == "skipped" and "full-attention" in \
        skipped["reason"]

    def data_dependent(*a, **k):
        raise RuntimeError("Cannot copy out of meta tensor; no data!")

    monkeypatch.setattr(dryrun.steps_lib, "make_train_step",
                        lambda *a, **k: data_dependent)
    row = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", False, args)
    assert row["status"] == "error" and "meta tensor" in row["reason"]
    assert "params_total" not in row
    assert not torch.distributed.is_initialized()
