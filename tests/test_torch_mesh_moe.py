"""PyTorch port vs the JAX package: the MoE layer on a mesh.

The port's ``moe_layer`` runs on 4 gloo ranks on the CPU
(``launch.mesh.launch_local``, a ("data", "model") mesh of (2, 2)); the
JAX ``moe_layer`` runs on a mesh of the same shape over 4 fake CPU devices
in one subprocess for the module, which writes an npz. Same numpy inputs
(x, router, expert weights, and the cotangent ``ct``), each rank cut its
blocks with ``parallel.sharding.shard``. The loss is
``sum(y * ct) + 0.3 aux + 0.7 z``; the port's outputs and gradients are
gathered back to global arrays on the ranks and held to JAX's:

* y, aux and z within 5e-5 and every gradient (x and each parameter)
  within 1e-3, JAX's own limits for its mesh modes
  (``tests/test_distributed.py``): hybrid, model_centric, data_centric,
  auto forced each way and ep (capacity 8: nothing dropped), under ag_rs
  and ag_ar, GLU and MLP experts (the MLP's output bias added once across
  TP), tokens sharded over "model" and replicated over it;
* a skewed Eq. 1 plan (6 rows over 2 data ranks: 4 + 2): the masked rows'
  output and gradient exactly 0 in both packages, the rest within the
  limits above; a uniform plan bit for bit the no-plan run;
* ``gather_ffn_params`` + ``pregathered=True`` bit for bit the in-island
  gather, and the refusals (a "node" axis, ``overlap_dispatch``,
  ``collect_router_stats``, true-quantized experts on a sharded mesh);
  ``make_production_mesh`` over the 4 ranks and ``split_model_axis``
  against JAX's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, D, F, E, K = 8, 16, 32, 64, 4, 2
AUX_W, Z_W = 0.3, 0.7
Y_TOL, GRAD_TOL = 5e-5, 1e-3
TOK_TP, TOK_REP = ("data", "model", None), ("data", None, None)

# (name, glu, mode, schedule, forced_layer_mode, x_spec, plan latencies)
CASES = [
    *[(f"glu-{m}{'-' + f if f else ''}-{s}", True, mode, s, f, TOK_TP, None)
      for m, mode, f in (("hybrid", "hybrid", None),
                         ("model", "model_centric", None),
                         ("data", "data_centric", None),
                         ("auto", "auto", "model_centric"),
                         ("auto", "auto", "data_centric"),
                         ("ep", "ep", None))
      for s in ("ag_rs", "ag_ar")],
    *[(f"mlp-{m}-ag_ar", False, mode, "ag_ar", None, TOK_TP, None)
      for m, mode in (("hybrid", "hybrid"), ("model", "model_centric"),
                      ("data", "data_centric"), ("ep", "ep"))],
    ("glu-hybrid-rep", True, "hybrid", "ag_rs", None, TOK_REP, None),
    ("mlp-model-rep", False, "model_centric", "ag_rs", None, TOK_REP, None),
    ("glu-hybrid-skew", True, "hybrid", "ag_rs", None, TOK_TP, (1.0, 2.0)),
    ("mlp-ep-skew", False, "ep", "ag_rs", None, TOK_TP, (1.0, 2.0)),
]
NAMES = [c[0] for c in CASES]
SKEW_BATCH = 6        # make_hetero_plan((1, 2), global_batch=6): (4, 2)


def _inputs(glu):
    rng = np.random.default_rng(7 if glu else 8)
    f32 = np.float32
    p = {"router": (rng.normal(size=(D, E)) * 0.1).astype(f32)}
    if glu:
        for name, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)),
                            ("w_down", (E, F, D))):
            p[name] = (rng.normal(size=shape) * 0.1).astype(f32)
    else:
        for name, shape in (("w1", (E, D, F)), ("b1", (E, F)),
                            ("w2", (E, F, D)), ("b2", (E, D))):
            p[name] = (rng.normal(size=shape) * 0.1).astype(f32)
    x = rng.normal(size=(B, S, D)).astype(f32)
    ct = rng.normal(size=(B, S, D)).astype(f32)
    return x, p, ct


JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.hetero import make_hetero_plan
from repro.launch.mesh import make_mesh
from repro.parallel.moe_parallel import MoEParams, MoEStatic, moe_layer
from repro.parallel.sharding import ParallelConfig

cases = json.loads(sys.argv[1])
data = np.load(sys.argv[2])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for name, glu, mode, sched, forced, spec, lat in cases:
    pre = "glu/" if glu else "mlp/"
    x, ct = data[pre + "x"], data[pre + "ct"]
    keys = [k[4:] for k in data.files
            if k.startswith(pre) and k[4:] not in ("x", "ct")]
    p = MoEParams(**{k: jnp.asarray(data[pre + k]) for k in keys})
    plan = (None if lat is None else
            make_hetero_plan(lat, global_batch=%(skew)d))
    cfg = ParallelConfig(mode=mode, collective_schedule=sched, blk=16,
                         capacity_factor=8.0, forced_layer_mode=forced,
                         hetero_plan=plan)
    ms = MoEStatic(num_experts=%(e)d, top_k=%(k)d, act="silu", glu=glu)
    xs = P(*[tuple(a) if isinstance(a, list) else a for a in spec])

    def loss(x, p):
        y, aux, z = moe_layer(x, p, ms, cfg, mesh, x_spec=xs)
        return (jnp.sum(y * ct) + %(aw)r * aux + %(zw)r * z), (y, aux, z)

    with mesh:
        (_, (y, aux, z)), (gx, gp) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)
    out[name + "/y"] = np.asarray(y)
    out[name + "/aux"] = np.asarray(aux)
    out[name + "/z"] = np.asarray(z)
    out[name + "/gx"] = np.asarray(gx)
    for k in keys:
        out[name + "/g_" + k] = np.asarray(getattr(gp, k))
np.savez(sys.argv[3], **out)
print("RESULT ok")
""" % dict(skew=SKEW_BATCH, e=E, k=K, aw=AUX_W, zw=Z_W)


def _port_rank(rank, cases):
    """One rank of the port's side: every case in turn, its outputs and
    gradients gathered to global arrays (returned by rank 0), and the
    pregathered run and the refusals checked on every rank."""
    import dataclasses

    from repro_torch.core.hetero import make_hetero_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import moe_parallel as mp
    from repro_torch.parallel.cache import gather_ffn_params
    from repro_torch.parallel.sharding import ParallelConfig, shard, unshard

    mesh = make_mesh((2, 2), ("data", "model"))
    out, check = {}, {}

    def run(glu, cfg, spec, pregathered=False):
        x, p, ct = _inputs(glu)
        table = mp.EP_PARAM_LOGICAL if cfg.mode == "ep" else \
            mp.MOE_PARAM_LOGICAL
        # x_spec names mesh axes, which resolve_spec passes through
        xcfg = ParallelConfig()
        xl = shard(torch.from_numpy(x), spec, xcfg, mesh).requires_grad_()
        ctl = shard(torch.from_numpy(ct), spec, xcfg, mesh)
        pl = {k: shard(torch.from_numpy(v), table[k], cfg, mesh)
              .requires_grad_() for k, v in p.items()}
        ms = mp.MoEStatic(E, K, act="silu", glu=glu, d_ff=F)
        use = gather_ffn_params(pl, cfg, mesh, d_ff=F) if pregathered else pl
        y, aux, z = mp.moe_layer(xl, use, ms, cfg, mesh, x_spec=spec,
                                 pregathered=pregathered)
        (torch.sum(y * ctl) + AUX_W * aux + Z_W * z).backward()
        res = {"y": unshard(y.detach(), spec, xcfg, mesh, x.shape),
               "aux": aux.detach(), "z": z.detach(),
               "gx": unshard(xl.grad, spec, xcfg, mesh, x.shape)}
        for k, v in pl.items():
            res["g_" + k] = unshard(v.grad, table[k], cfg, mesh, p[k].shape)
        return {k: v.numpy() for k, v in res.items()}

    for name, glu, mode, sched, forced, spec, lat in cases:
        plan = (None if lat is None else
                make_hetero_plan(lat, global_batch=SKEW_BATCH))
        cfg = ParallelConfig(mode=mode, collective_schedule=sched, blk=16,
                             capacity_factor=8.0, forced_layer_mode=forced,
                             hetero_plan=plan)
        res = run(glu, cfg, tuple(spec))
        out.update({f"{name}/{k}": v for k, v in res.items()})

    # a uniform plan is the no-plan run, bit for bit
    base = ParallelConfig(mode="hybrid", blk=16)
    uni = run(True, dataclasses.replace(
        base, hetero_plan=make_hetero_plan((1.0, 1.0), global_batch=B)),
        TOK_TP)
    ref = run(True, base, TOK_TP)
    check["uniform_plan_bitwise"] = all(np.array_equal(uni[k], ref[k])
                                        for k in ref)
    # the fsdp gather outside the island: the same values and gradients
    pre = run(True, base, TOK_TP, pregathered=True)
    check["pregathered_bitwise"] = all(np.array_equal(pre[k], ref[k])
                                       for k in ("y", "aux", "z"))
    check["pregathered_grad_err"] = max(float(np.abs(pre[k] - ref[k]).max())
                                        for k in ref)
    refusals = {}
    x, p, _ = _inputs(True)
    ms = mp.MoEStatic(E, K, glu=True, d_ff=F)
    for what, cfg in (("overlap", dataclasses.replace(base,
                                                      overlap_dispatch=True)),
                      ("stats", dataclasses.replace(
                          base, collect_router_stats=True))):
        try:
            mp.moe_layer(torch.from_numpy(x[:4, :8]), {}, ms, cfg, mesh,
                         x_spec=TOK_TP)
            refusals[what] = "ran"
        except NotImplementedError as e:
            refusals[what] = str(e)
    try:
        qp = {k: shard(torch.from_numpy(v), mp.MOE_PARAM_LOGICAL[k], base,
                       mesh) for k, v in p.items()}
        qp["w_gate_scale"] = torch.ones(E, 1, 1)
        mp.moe_layer(shard(torch.from_numpy(x), TOK_TP, base, mesh), qp, ms,
                     base, mesh, x_spec=TOK_TP)
        refusals["quantized"] = "ran"
    except NotImplementedError as e:
        refusals["quantized"] = str(e)
    check["refusals"] = refusals
    from repro_torch.launch.mesh import make_production_mesh

    prod = make_production_mesh(model=2)
    check["production_mesh"] = (prod.axis_names, prod.shape)
    return (out, check) if rank == 0 else (None, check)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    arrays = {}
    for glu in (True, False):
        x, p, ct = _inputs(glu)
        pre = "glu/" if glu else "mlp/"
        arrays.update({pre + "x": x, pre + "ct": ct,
                       **{pre + k: v for k, v in p.items()}})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(CASES),
         str(tmp / "in.npz"), str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 4, CASES, timeout=240)
        stdout, stderr = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, stderr[-3000:]
    jax_out = dict(np.load(tmp / "jax.npz"))
    return jax_out, port[0][0], [c for _, c in port]


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_moe_layer_matches_jax_on_mesh(results, case):
    jax_out, port, _ = results
    name = case[0]
    keys = [k.split("/", 1)[1] for k in jax_out if k.startswith(name + "/")]
    assert set(keys) == {k.split("/", 1)[1] for k in port
                         if k.startswith(name + "/")}
    for k in keys:
        a, b = port[f"{name}/{k}"], jax_out[f"{name}/{k}"]
        tol = GRAD_TOL if k.startswith("g") else Y_TOL
        err = float(np.abs(a - b).max())
        assert err <= tol, (name, k, err)


@pytest.mark.parametrize("name", ["glu-hybrid-skew", "mlp-ep-skew"])
def test_skewed_plan_masks_rows_exactly(results, name):
    """Data rank 1 holds batch rows 4-7, of which its share is 2: rows 6
    and 7 are its masked tail in both packages."""
    jax_out, port, _ = results
    for out in (jax_out, port):
        assert not np.any(out[f"{name}/y"][6:])
        assert not np.any(out[f"{name}/gx"][6:])
        assert np.all(np.abs(out[f"{name}/y"][:6]).sum(-1) > 0)


def test_uniform_plan_and_pregathered_are_the_plain_run(results):
    _, _, checks = results
    for c in checks:
        assert c["uniform_plan_bitwise"]
        assert c["pregathered_bitwise"]
        assert c["pregathered_grad_err"] <= 1e-6


def test_mesh_refusals_name_the_roadmap(results):
    _, _, checks = results
    for c in checks:
        refusals = dict(c["refusals"])
        # true-quantized experts on a sharded mesh raise, as JAX's do
        assert "true-quantized" in refusals.pop("quantized")
        for what, msg in refusals.items():
            assert "ROADMAP.md" in msg, (what, msg)


def test_production_mesh_and_model_axis_split(results):
    from repro.launch.mesh import split_model_axis as jsplit
    from repro_torch.launch.mesh import split_model_axis as tsplit

    _, _, checks = results
    for c in checks:
        assert c["production_mesh"] == (("data", "model"),
                                        {"data": 2, "model": 2})
    for shape, axes, node in (((4, 8), ("data", "model"), 4),
                              ((2, 2, 8), ("pod", "data", "model"), 2),
                              ((4, 8), ("data", "model"), 8),
                              ((4, 6), ("data", "model"), 4),
                              ((8,), ("data",), 2)):
        assert tsplit(shape, axes, node) == jsplit(shape, axes, node)


def test_node_axis_is_refused():
    from repro_torch.parallel import moe_parallel as mp
    from repro_torch.parallel.sharding import ParallelConfig

    class NodeMesh:
        axis_names = ("data", "node", "model")
        shape = {"data": 1, "node": 2, "model": 2}

    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        mp.moe_layer(torch.zeros(1, 2, D), {}, mp.MoEStatic(E, K, d_ff=F),
                     ParallelConfig(), NodeMesh(), x_spec=TOK_TP)
