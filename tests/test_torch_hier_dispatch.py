"""PyTorch port vs the JAX package: the two-level "node" schedule and the
overlap schedule on 8 gloo ranks.

The port runs on ``launch.mesh.launch_local`` ranks; JAX on 8 fake CPU
devices in one subprocess, started while the ranks run. Two node meshes,
("data", "node", "model") = (1, 2, 4) and (2, 2, 2), each the flat
("data", "model") mesh with its model extent split by
``split_model_axis`` under ``Topology(50e9, 12.5e9, node_size)``.

* The MoE island (``moe_layer``, x placed ("data", ("node", "model"),
  None); GLU experts in hybrid, model_centric under ag_rs and ag_ar,
  data_centric, auto forced to either dispatch and auto's own chooser;
  MLP experts in hybrid, model_centric and data_centric) with the
  topology set, against JAX's island on the same mesh: the output and
  aux/z within 1e-5 x max|ref|, every gradient within 1e-4 x its
  max|grad|.
* The port's hierarchical schedule against its flat one (the same mesh,
  no topology): the forward bit for bit where only gathers are phased
  (auto forced to data-centric), within 1e-6 x max|y| where the partial
  sums are combined node-locally first (one f32 reassociation); the
  gradients within 1e-5 x max|grad| (the phased gathers' adjoints are
  two reduce-scatters, which sum in another order). Auto's own chooser
  prices the topology, so it may pick the other dispatch than on the
  flat schedule: its output within 1e-5 x max|y|, as JAX's test holds it.
* ``split_model_axis``'s rank order, on both meshes and on ("pod",
  "data", "node", "model") = (1, 2, 2, 2): ``Mesh.index(("node",
  "model"))`` is the flat mesh's "model" coordinate on every rank, and a
  gather phased over "model" then "node" is the flat gather bit for bit.
* The LM (qwen3-moe-30b-a3b's smoke config, f32, 2 layers) under auto
  forced data-centric with the prefetch cache (``cache_layers=2``): the
  overlap schedule's prefill logits bit for bit the eager schedule's,
  the cache's residency bounded by 2 with prefetches and hits, and both
  within 1e-5 x max|ref| of JAX's overlap run on the same mesh.
* The paged engine (and ``greedy_reference``) on the split (2, 2, 2) mesh
  streams the flat (2, 4) mesh's tokens (the counterpart of
  ``tests/test_serve_parity.py::test_hier_topology_serving_token_
  identical``).
* The CLIs' ``--topology``, ``--overlap-dispatch`` and serve
  ``--hetero-latencies`` errors, equal to the JAX CLIs' messages; the
  train CLI on 4 ranks with ``--mesh 1,4 --topology`` against the flat
  mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local
from test_torch_mesh_lm import _nest, _sub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, D, F, E, K = 8, 16, 32, 64, 4, 2
AUX_W, Z_W = 0.3, 0.7
Y_TOL, GRAD_TOL, HIER_TOL = 1e-5, 1e-4, 1e-6
LB, LS = 8, 16                       # the LM's batch
QWEN = "qwen3-moe-30b-a3b"
TOPO = {"124": (50e9, 12.5e9, 4), "222": (50e9, 12.5e9, 2)}
FLAT = {"124": (1, 8), "222": (2, 4)}
X_SPEC = ("data", ("node", "model"), None)

# (name, glu, mode, schedule, forced_layer_mode)
ISLAND = [
    ("glu-hybrid-ag_rs", True, "hybrid", "ag_rs", None),
    ("glu-hybrid-ag_ar", True, "hybrid", "ag_ar", None),
    ("glu-model-ag_rs", True, "model_centric", "ag_rs", None),
    ("glu-model-ag_ar", True, "model_centric", "ag_ar", None),
    ("glu-data", True, "data_centric", "ag_rs", None),
    ("glu-auto_mc", True, "auto", "ag_rs", "model_centric"),
    ("glu-auto_dc", True, "auto", "ag_rs", "data_centric"),
    ("glu-auto", True, "auto", "ag_rs", None),
    ("mlp-hybrid-ag_rs", False, "hybrid", "ag_rs", None),
    ("mlp-model-ag_ar", False, "model_centric", "ag_ar", None),
    ("mlp-data", False, "data_centric", "ag_rs", None),
]
CASES = [(m, c) for m in TOPO for c in ISLAND]
IDS = [f"{m}-{c[0]}" for m, c in CASES]


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


def _lm_cfg():
    import dataclasses

    from repro_torch import configs as cfglib

    return dataclasses.replace(cfglib.get_smoke_config(QWEN),
                               dtype="float32", num_layers=2)


JAX_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs as cfglib
from repro.launch.inputs import activation_spec
from repro.launch.mesh import make_mesh, split_model_axis
from repro.models import lm
from repro.parallel.autotune import Topology
from repro.parallel.moe_parallel import MoEParams, MoEStatic, moe_layer
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings

cases, topos, flats = (json.loads(a) for a in sys.argv[1:4])
data = np.load(sys.argv[4])
out = {}
for mkey, (intra, inter, node) in topos.items():
    topo = Topology(intra_bw=intra, inter_bw=inter, node_size=node)
    dims, axes = split_model_axis(tuple(flats[mkey]), ("data", "model"),
                                  node)
    mesh = make_mesh(dims, axes)
    xs = P("data", ("node", "model"), None)
    for name, glu, mode, sched, forced in cases:
        pre = "glu/" if glu else "mlp/"
        x, ct = data[pre + "x"], data[pre + "ct"]
        keys = [k[4:] for k in data.files
                if k.startswith(pre) and k[4:] not in ("x", "ct")]
        p = MoEParams(**{k: jnp.asarray(data[pre + k]) for k in keys})
        cfg = ParallelConfig(mode=mode, collective_schedule=sched, blk=16,
                             forced_layer_mode=forced, topology=topo)
        ms = MoEStatic(num_experts=%(e)d, top_k=%(k)d, act="silu", glu=glu)

        def loss(x, p):
            y, aux, z = moe_layer(x, p, ms, cfg, mesh, x_spec=xs)
            return (jnp.sum(y * ct) + %(aw)r * aux + %(zw)r * z), (y, aux, z)

        with mesh:
            (_, (y, aux, z)), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)
        key = mkey + "/" + name
        out[key + "/y"] = np.asarray(y)
        out[key + "/aux"] = np.asarray(aux)
        out[key + "/z"] = np.asarray(z)
        out[key + "/gx"] = np.asarray(gx)
        for k in keys:
            out[key + "/g_" + k] = np.asarray(getattr(gp, k))
    # the LM under the overlap schedule on this mesh
    cfg = dataclasses.replace(cfglib.get_smoke_config("%(arch)s"),
                              dtype="float32", num_layers=2)
    params, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
    pcfg = ParallelConfig(mode="auto", blk=8, scan_layers=False,
                          cache_layers=2, overlap_dispatch=True,
                          forced_layer_mode="data_centric", topology=topo)
    shape3 = (%(lb)d, %(ls)d, cfg.d_model)
    with mesh:
        pp = jax.tree.map(jax.device_put, params,
                          tree_shardings(params, specs, pcfg, mesh))
        logits = jax.jit(lambda p, t: lm.forward(
            p, {"tokens": t}, cfg, pcfg, mesh, mode="prefill",
            x_spec=activation_spec(shape3, pcfg, mesh))[0])(
            pp, jnp.asarray(data["lm/tokens"]))
    out[mkey + "/lm_logits"] = np.asarray(logits)
np.savez(sys.argv[5], **out)
print("RESULT ok")
""" % dict(e=E, k=K, aw=AUX_W, zw=Z_W, arch=QWEN, lb=LB, ls=LS)


def _port_rank(rank, tmp):
    """One rank: both node meshes, every island case with the topology
    and without it, the rank-order and phased-gather checks, and the LM's
    eager and overlap prefills."""
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh, split_model_axis
    from repro_torch.models import lm
    from repro_torch.parallel import moe_parallel as mp
    from repro_torch.parallel.autotune import Topology
    from repro_torch.parallel.sharding import ParallelConfig, shard, unshard

    data = dict(np.load(os.path.join(tmp, "in.npz")))
    out = {}

    def order(flat, mesh):
        """The split mesh's ("node", "model") index is the flat mesh's
        "model" coordinate, and a gather phased over "model" then "node"
        is the flat gather bit for bit."""
        t = torch.arange(3, dtype=torch.float32) + 10 * rank
        phased = mp._ag_hier(t, mesh, ("node", "model"), 0, True)
        return (mesh.index(("node", "model")) == flat.coord("model")
                and all(mesh.coord(a) == flat.coord(a)
                        for a in flat.axis_names if a != "model")
                and torch.equal(phased, flat.all_gather(t, "model", 0))
                and torch.equal(phased, mesh.all_gather(
                    t, ("node", "model"), 0)))

    flat = make_mesh((1, 2, 4), ("pod", "data", "model"))
    out["pod/order"] = order(flat, make_mesh(*split_model_axis(
        (1, 2, 4), ("pod", "data", "model"), 2)))
    for mkey, (intra, inter, node) in TOPO.items():
        topo = Topology(intra_bw=intra, inter_bw=inter, node_size=node)
        dims, axes = split_model_axis(FLAT[mkey], ("data", "model"), node)
        flat = make_mesh(FLAT[mkey], ("data", "model"))
        mesh = make_mesh(dims, axes)
        out[mkey + "/order"] = order(flat, mesh)
        for name, glu, mode, sched, forced in ISLAND:
            x, p, ct = _inputs(glu)
            ms = mp.MoEStatic(E, K, act="silu", glu=glu, d_ff=F)
            table = mp.MOE_PARAM_LOGICAL
            for hier in (True, False):
                cfg = ParallelConfig(mode=mode, collective_schedule=sched,
                                     blk=16, forced_layer_mode=forced,
                                     topology=topo if hier else None)
                xcfg = ParallelConfig()
                xl = shard(torch.from_numpy(x), X_SPEC, xcfg,
                           mesh).requires_grad_()
                ctl = shard(torch.from_numpy(ct), X_SPEC, xcfg, mesh)
                pl = {k: shard(torch.from_numpy(v), table[k], cfg, mesh)
                      .requires_grad_() for k, v in p.items()}
                y, aux, z = mp.moe_layer(xl, pl, ms, cfg, mesh,
                                         x_spec=X_SPEC)
                total = torch.sum(y * ctl) + AUX_W * aux + Z_W * z
                grads = torch.autograd.grad(total, [xl, *pl.values()])
                key = f"{mkey}/{name}/{'hier' if hier else 'flat'}"
                res = {"y": unshard(y.detach(), X_SPEC, xcfg, mesh,
                                    (B, S, D)),
                       "aux": float(aux), "z": float(z),
                       "gx": unshard(grads[0], X_SPEC, xcfg, mesh,
                                     (B, S, D))}
                for (k, v), g in zip(p.items(), grads[1:]):
                    res["g_" + k] = unshard(g, table[k], cfg, mesh, v.shape)
                out[key] = {k: (v.numpy() if torch.is_tensor(v) else v)
                            for k, v in res.items()}
        # the LM: eager and overlap prefills, forced data-centric
        cfg = _lm_cfg()
        tree = params_from_jax(_nest(_sub(data, "lm/p/")), cfg,
                               device="cpu")
        shape3 = (LB, LS, cfg.d_model)
        for overlap in (False, True):
            pcfg = ParallelConfig(mode="auto", blk=8, cache_layers=2,
                                  overlap_dispatch=overlap,
                                  forced_layer_mode="data_centric",
                                  topology=topo)
            x_spec = activation_spec(shape3, pcfg, mesh)
            pl = shard_params(tree, lm.param_specs(cfg, pcfg), pcfg, mesh,
                              device="cpu")
            toks = batch_block({"tokens": torch.from_numpy(
                data["lm/tokens"])}, x_spec, mesh)
            lm.LAST_PIPELINE_CACHE_STATS = None
            with torch.no_grad():
                logits, _, _, _ = lm.forward(pl, toks, cfg, pcfg,
                                             mode="prefill", mesh=mesh,
                                             x_spec=x_spec)
            logits = mesh.all_gather(logits, x_spec[0], 0)
            out[f"{mkey}/lm/{overlap}"] = (
                logits.numpy(), dict(lm.LAST_PIPELINE_CACHE_STATS))
        if mkey == "222":
            out["paged"] = {
                "flat": _paged_streams(tree, cfg, flat,
                                       ParallelConfig(blk=8)),
                "hier": _paged_streams(tree, cfg, mesh, ParallelConfig(
                    blk=8, topology=topo))}
    return out if rank == 0 else None


def _paged_streams(tree, cfg, mesh, pcfg):
    """The paged engine's greedy streams on ``mesh`` (4 slots, 4-token
    pages, chunks of 5, slots refilled) and ``greedy_reference``'s, as
    ``tests/test_serve_parity.py::test_hier_topology_serving_token_
    identical`` draws its requests."""
    from repro_torch.convert import shard_params
    from repro_torch.launch import serve
    from repro_torch.models import lm

    rng = np.random.default_rng(11)
    reqs = []
    for i in range(6):
        plen = int(rng.integers(2, 14))
        reqs.append(serve.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, size=plen).astype(
                np.int32), max_new=int(rng.integers(1, 6))))
    params = shard_params(tree, lm.param_specs(cfg, pcfg), pcfg, mesh,
                          device="cpu")
    srv = serve.PagedServer(cfg, pcfg, num_slots=4, page_size=4,
                            num_pages=1 + 4 * 8, max_pages_per_slot=8,
                            params=params, prefill_chunk=5, device="cpu",
                            mesh=mesh)
    for r in reqs:
        srv.submit(r)
    with torch.no_grad():
        done = srv.run()
        refs = {r.rid: serve.greedy_reference(
            cfg, pcfg, params, r.prompt, r.max_new, max_seq=32, mesh=mesh)
            for r in reqs}
    srv.pool.assert_consistent()
    return {r.rid: list(r.out) for r in done}, refs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    tmp = tmp_path_factory.mktemp("hier")
    arrays = {}
    for glu in (True, False):
        x, p, ct = _inputs(glu)
        pre = "glu/" if glu else "mlp/"
        arrays[pre + "x"], arrays[pre + "ct"] = x, ct
        arrays.update({pre + k: v for k, v in p.items()})
    jcfg = dataclasses.replace(jcfglib.get_smoke_config(QWEN),
                               dtype="float32", num_layers=2)
    params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arrays["lm/p/" + key] = np.asarray(leaf)
    arrays["lm/tokens"] = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(LB, LS)).astype(np.int32)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(ISLAND),
         json.dumps(TOPO), json.dumps(FLAT), str(tmp / "in.npz"),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 8, str(tmp), timeout=300)[0]
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "jax.npz")), port


def _close(got, want, tol_rel, what):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol_rel * scale, (what, err, scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hier_island_matches_jax(results, case):
    jax_out, port = results
    mkey, (name, glu, *_) = case
    key = f"{mkey}/{name}"
    r = port[key + "/hier"]
    _close(r["y"], jax_out[key + "/y"], Y_TOL, "y")
    for k in ("aux", "z"):
        np.testing.assert_allclose(r[k], float(jax_out[f"{key}/{k}"]),
                                   rtol=Y_TOL)
    for k in [k for k in r if k.startswith("g")]:
        _close(r[k], jax_out[f"{key}/{k}"], GRAD_TOL, k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hier_schedule_against_flat(results, case):
    """Data-centric dispatch only phases gathers: its forward is the flat
    one bit for bit. The rest combine node-locally first: one f32
    reassociation."""
    _, port = results
    mkey, (name, glu, mode, sched, forced) = case
    h, f = port[f"{mkey}/{name}/hier"], port[f"{mkey}/{name}/flat"]
    if mode == "auto" and forced is None:
        _close(h["y"], f["y"], Y_TOL, "y")
        return
    if mode == "data_centric" or forced == "data_centric":
        for k in ("y", "aux", "z"):
            np.testing.assert_array_equal(h[k], f[k], err_msg=k)
    else:
        _close(h["y"], f["y"], HIER_TOL, "y")
    for k in [k for k in h if k.startswith("g")]:
        _close(h[k], f[k], HIER_TOL * 10, k)


@pytest.mark.parametrize("mkey", [*TOPO, "pod"])
def test_split_model_axis_rank_order(results, mkey):
    """On (1, 2, 4), (2, 2, 2) and ("pod", "data", "node", "model") =
    (1, 2, 2, 2)."""
    _, port = results
    assert port[mkey + "/order"] is True


def test_hier_topology_serving_token_identical(results):
    """Paged serving on the split mesh (2, 2, 2) streams token for token
    what the flat (2, 4) mesh streams, and so does the batch-1
    ``greedy_reference`` on the same meshes: the topology reshapes the
    collectives, never the tokens (the JAX test of the same name)."""
    _, port = results
    (flat, flat_ref), (hier, hier_ref) = (port["paged"]["flat"],
                                          port["paged"]["hier"])
    assert len(flat) == 6
    assert hier == flat
    assert hier_ref == flat_ref


@pytest.mark.parametrize("mkey", list(TOPO))
def test_overlap_bitwise_eager_and_residency(results, mkey):
    jax_out, port = results
    eager, st0 = port[f"{mkey}/lm/False"]
    ovl, st1 = port[f"{mkey}/lm/True"]
    np.testing.assert_array_equal(ovl, eager)
    _close(ovl, jax_out[mkey + "/lm_logits"], Y_TOL, "logits")
    for st in (st0, st1):
        assert st["peak_resident_layers"] <= 2, st
        assert st["prefetches"] > 0 and st["hits"] > 0, st
    # the overlap entries hold whole expert weights (the TP factor too)
    assert st1["peak_resident_bytes"] > st0["peak_resident_bytes"]


def _cli_error(main, argv, capsys):
    with pytest.raises(SystemExit) as err:
        main(argv)
    assert err.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("which,argv", [
    ("train", ["--topology", "1:2"]),
    ("train", ["--topology", "a:b:c"]),
    ("train", ["--overlap-dispatch"]),
    ("serve", ["--topology", "1:2"]),
    ("serve", ["--hetero-latencies", "1,2"]),
])
def test_cli_errors_equal_jax(which, argv, capsys):
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    base = ["--arch", QWEN, "--smoke"]
    port_main, jax_main = ((ttrain.main, jtrain.main) if which == "train"
                           else (tserve.main, jserve.main))
    got = _cli_error(port_main, base + ["--device", "cpu"] + argv, capsys)
    want = _cli_error(jax_main, base + argv, capsys)
    assert got == want


def _train_cli_rank(rank, argv):
    from repro_torch.launch import train

    return [m["loss"] for m in train.main(argv)]


def test_train_cli_topology_splits_the_mesh():
    """The train CLI on 4 gloo ranks: ``--mesh 1,4 --topology`` trains on
    ("data", "node", "model") = (1, 2, 2) with the overlap schedule asked
    for, the losses within 2e-4 of the flat mesh's, relative (the smoke
    config is bf16: the node-local combine's reassociation is rounded to
    bf16; measured 3.3e-5 at the second step)."""
    base = ["--arch", QWEN, "--smoke", "--steps", "2", "--global-batch",
            "2", "--seq-len", "16", "--layers", "2", "--device", "cpu",
            "--mesh", "1,4", "--mode", "auto", "--cache-layers", "2"]
    flat = launch_local(_train_cli_rank, 4, base, timeout=240)[0]
    node = launch_local(_train_cli_rank, 4, base + [
        "--topology", "50e9:12.5e9:2", "--overlap-dispatch"],
        timeout=240)[0]
    np.testing.assert_allclose(node, flat, rtol=2e-4)
