"""PyTorch port vs the JAX package: the paged engine on a mesh.

The port's ``PagedServer(mesh=)`` runs on 4 gloo ranks on the CPU
(``launch.mesh.launch_local``, a ("data", "model") mesh of (2, 2), every
case in one launch); JAX's ``PagedServer`` on a mesh of the same shape
over 4 fake CPU devices, in one subprocess for the module. Weights: JAX's
init of the f32 smoke configs (``split_tree(lm.init_params(PRNGKey(0),
cfg))``, padded by the hetero plan where a case has one), written by the
JAX script before its runs, carried over by ``convert.params_from_jax``
and cut by ``convert.shard_params``; both
packages in ``mode="hybrid"``, blk 8. 4 slots (two a "data" rank), a
pool of 16 4-token pages, chunks of 5; the JAX script builds each step
once a configuration (the engine rebuilds its steps for every server),
so the cases share their compilations.

Each case's streams, its whole scheduler ``trace``, the pool's and the
prefix index's counters, the roles, the failed requests and the faults
that fired equal JAX's, and are the same on every rank; every rank's
page books pass ``assert_page_invariants`` and drain. The cases: qwen3-
moe-30b-a3b plain, with the prefix cache (a shared system prompt, so a
slot of one "data" rank reads pages another's wrote), with strict
disaggregated roles (slots 0-1 prefill, 2-3 decode: every handoff crosses
"data" ranks), over int8 pages, under a hetero plan's page shares (Eq. 1
(1, 2) with Eq. 2 widths), with n-gram speculation, under faults (an
engine error, NaN logits, a device dropout), priority preemption and
deadlines on a tick clock (``PagedServer._AgreedClock``); Jamba's smoke
config (Mamba state over the ranks: the scan prefill, sampled at 0.8,
state handed off across "data" ranks); gemma-2b (MQA: K/V whole on each
"model" rank) under speculation, whose drafts are accepted; and the
MLP-experts graft (``glu=False``), whose loss and
gradient norm on the mesh are also JAX's (rtol 1e-5 and 1e-4).

Also: the per-rank cache blocks (every page; K/V heads split where they
divide, whole for MQA; Mamba's slots and channels split), and
``paged_cache_logical_specs`` against JAX's (the counterpart of
``tests/test_serve_parity.py::test_paged_cache_specs_mirror_cache_tree``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN, JAMBA, GEMMA = "qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "gemma-2b"
GRAFT = "graft"
SLOTS, PAGE, CHUNK, MAXP, PAGES = 4, 4, 5, 8, 17
HETERO = dict(latencies=(1.0, 2.0), global_batch=4, hidden_size=32,
              tp_latencies=(1.0, 2.0))
LOSS_SHAPE = (4, 16)


def _f(site, kind, **kw):
    return dict(site=site, kind=kind, **kw)


#: name -> (model, request set, engine keywords, spec k, faults, clock)
CASES = {
    "plain": (QWEN, "base", {}, 0, [], False),
    "prefix": (QWEN, "prefix", {"prefix_cache": True}, 0, [], False),
    "disagg": (QWEN, "base", {"disagg": True}, 0, [], False),
    "int8": (QWEN, "prefix", {"kv_quant": "int8", "prefix_cache": True}, 0,
             [], False),
    "hetero": ("qwen-hetero", "base", {"disagg": True}, 0, [], False),
    "spec": (QWEN, "spec", {}, 3, [], False),
    "faults": ("qwen-hetero", "prefix", {"prefix_cache": True}, 0, [
        _f("serve.decode", "error", at=1),
        _f("serve.logits", "nan", at=3, payload={"slot": 2}),
        _f("serve.decode", "device_drop", at=6,
           payload={"survivors": [0]})], False),
    "preempt": (QWEN, "preempt", {"prefix_cache": True}, 0, [], False),
    "deadline": (QWEN, "deadline", {}, 0, [], True),
    "jamba": (JAMBA, "sampled", {"disagg": True}, 0, [], False),
    "gemma": (GEMMA, "spec", {}, 3, [], False),
    "graft": (GRAFT, "sampled", {}, 0, [], False),
}
MODELS = {QWEN: (QWEN, {}, False), "qwen-hetero": (QWEN, {}, True),
          JAMBA: (JAMBA, {}, False), GEMMA: (GEMMA, {}, False),
          GRAFT: (QWEN, {"glu": False}, False)}


def _requests(kind, vocab):
    """The request dicts of a case (JSON-ready)."""
    rng = np.random.default_rng(11)

    def toks(n):
        return rng.integers(0, vocab, size=n).tolist()

    if kind in ("base", "sampled"):
        temp = 0.8 if kind == "sampled" else 0.0
        return [dict(rid=i, prompt=toks(int(rng.integers(2, 12))),
                     max_new=int(rng.integers(2, 6)), seed=i,
                     temperature=temp if i % 2 else 0.0) for i in range(6)]
    if kind == "prefix":
        # rid 2 (slot 2, "data" rank 1) finishes at its first token, so a
        # later request takes its slot while rid 0's prompt pages are
        # indexed
        system = toks(8)
        return [dict(rid=i, prompt=system + toks(int(rng.integers(1, 5))),
                     max_new=(6, 6, 1, 6, 3, 3)[i]) for i in range(6)]
    if kind == "spec":
        return [dict(rid=i, prompt=(toks(3) * 4)[:10 + i % 2], max_new=6)
                for i in range(5)]
    if kind == "preempt":
        # two requests reserve all 16 pages; a higher-priority head
        # preempts the younger
        low = [dict(rid=i, prompt=toks(8), max_new=25) for i in range(2)]
        return low + [dict(rid=2, prompt=toks(4), max_new=2, priority=5)]
    # deadline: a queued request's budget passes while every slot is busy
    reqs = [dict(rid=i, prompt=toks(6), max_new=6) for i in range(4)]
    return reqs + [dict(rid=4, prompt=toks(5), max_new=3, deadline_s=6.0)]


def _plain(o):
    return o.tolist() if hasattr(o, "tolist") else list(o)


class TickClock:
    """A clock that advances one unit a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


JAX_SCRIPT = r"""
import dataclasses, functools, json, os, sys
import numpy as np
import jax
from repro import configs as cfglib
from repro.core.hetero import make_hetero_plan
from repro.launch import serve, spec, steps
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings
from repro.runtime import faults

job = json.load(open(sys.argv[1]))
mesh = make_mesh((2, 2), ("data", "model"))
plan = make_hetero_plan(tuple(job["hetero"]["latencies"]),
                        global_batch=job["hetero"]["global_batch"],
                        hidden_size=job["hetero"]["hidden_size"],
                        tp_latencies=tuple(job["hetero"]["tp_latencies"]))


def _plain(o):
    return o.tolist() if hasattr(o, "tolist") else list(o)


class TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# every builder of a step returns one function a configuration, so that
# the servers of the cases (and engine recovery) reuse its compilation
def _memo(build):
    made = {}

    def get(*args):
        key = repr(args)
        if key not in made:
            made[key] = build(*args)
        return made[key]

    return get


for _name in ("make_paged_serve_step", "make_paged_prefill_step",
              "make_paged_score_step", "make_paged_handoff_step",
              "make_page_copy_step"):
    setattr(steps, _name, _memo(getattr(steps, _name)))


@functools.lru_cache(maxsize=None)
def model(name):
    arch, extra, hetero = job["models"][name]
    cfg = dataclasses.replace(cfglib.get_smoke_config(arch), dtype="float32",
                              **extra)
    p = plan if hetero else None
    pcfg = ParallelConfig(blk=8, mode="hybrid", hetero_plan=p)
    params, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg,
                                              plan=p))
    params = jax.tree.map(jax.device_put, params,
                          tree_shardings(params, specs, pcfg, mesh))
    return cfg, pcfg, params, p


# the weights for the port's ranks, which wait for "params.ready"
tmp = os.path.dirname(sys.argv[1])
for name in job["models"]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            model(name)[2])[0]:
        flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)] = np.asarray(leaf)
    np.savez(os.path.join(tmp, name + ".npz"), **flat)
open(os.path.join(tmp, "params.ready"), "w").close()

out = {}
with mesh:
    for name, (mname, reqs, kw, k, fl, tick) in job["cases"].items():
        cfg, pcfg, params, p = model(mname)
        extra = {"clock": TickClock()} if tick else {}
        srv = serve.PagedServer(cfg, pcfg, mesh, num_slots=job["slots"],
                                page_size=job["page"], num_pages=job["pages"],
                                max_pages_per_slot=job["maxp"], params=params,
                                prefill_chunk=job["chunk"], plan=p,
                                audit=True, **kw, **extra)
        if k:
            spec.SpecDecoder(srv, spec.NGramDrafter(), k=k)
        for r in reqs:
            srv.submit(serve.Request(**dict(
                r, prompt=np.asarray(r["prompt"], np.int32))))
        fp = faults.FaultPlan([faults.Fault(**f) for f in fl])
        with faults.scope(fp):
            done = srv.run()
        srv.pool.assert_consistent()
        out[name] = {
            "streams": {str(r.rid): list(map(int, r.out)) for r in done},
            "trace": srv.trace, "stats": srv.stats(), "roles": srv.roles,
            "failed": [[r.rid, r.error] for r in srv.failed],
            "fired": fp.fired,
            "spec": srv.spec.stats() if srv.spec is not None else None}
    cfg, pcfg, params, _ = model("graft")
    data = np.load(sys.argv[3])
    batch = {k: jax.numpy.asarray(data[k]) for k in data.files}
    b, s = job["loss_shape"]
    loss_fn = steps.make_loss_fn(cfg, pcfg, mesh, (b, s, cfg.d_model))
    (total, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)
    gnorm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                              for g in jax.tree.leaves(grads))))
    out["graft_loss"] = {"total": float(total), "grad_norm": gnorm}
json.dump(out, open(sys.argv[2], "w"), default=_plain)
print("RESULT ok")
"""


def _cfg(mname):
    from repro_torch import configs as cfglib

    arch, extra, _ = MODELS[mname]
    return dataclasses.replace(cfglib.get_smoke_config(arch), dtype="float32",
                               **extra)


def _plan():
    from repro_torch.core.hetero import make_hetero_plan

    h = HETERO
    return make_hetero_plan(h["latencies"], global_batch=h["global_batch"],
                            hidden_size=h["hidden_size"],
                            tp_latencies=h["tp_latencies"])


def _nest(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _wait_for_params(tmp, timeout=240.0):
    import time

    t0 = time.monotonic()
    while not os.path.exists(os.path.join(tmp, "params.ready")):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("the JAX script wrote no weights")
        time.sleep(0.2)


def _port_model(mname, tmp, mesh):
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = _cfg(mname)
    plan = _plan() if MODELS[mname][2] else None
    pcfg = ParallelConfig(blk=8, mode="hybrid", hetero_plan=plan)
    flat = dict(np.load(os.path.join(tmp, f"{mname}.npz")))
    full = params_from_jax(_nest(flat), cfg, device="cpu")
    return cfg, pcfg, shard_params(full, lm.param_specs(cfg, pcfg), pcfg,
                                   mesh, device="cpu"), plan


def _port_rank(rank, tmp):
    """Every case on this rank; the results (rank 0's and every rank's
    streams and traces, to check they agree)."""
    from repro_torch.common import tree_leaves
    from repro_torch.launch import serve, spec, steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import faults

    mesh = make_mesh((2, 2), ("data", "model"))
    job = json.load(open(os.path.join(tmp, "job.json")))
    _wait_for_params(tmp)
    out = {}
    for name, (mname, reqs, kw, k, fl, tick) in job["cases"].items():
        cfg, pcfg, params, plan = _port_model(mname, tmp, mesh)
        extra = {"clock": TickClock()} if tick else {}
        srv = serve.PagedServer(cfg, pcfg, num_slots=SLOTS, page_size=PAGE,
                                num_pages=PAGES, max_pages_per_slot=MAXP,
                                params=params, prefill_chunk=CHUNK, plan=plan,
                                audit=True, device="cpu", mesh=mesh, **kw,
                                **extra)
        if k:
            spec.SpecDecoder(srv, spec.NGramDrafter(), k=k)
        for r in reqs:
            srv.submit(serve.Request(**dict(
                r, prompt=np.asarray(r["prompt"], np.int32))))
        fp = faults.FaultPlan([faults.Fault(**f) for f in fl])
        with faults.scope(fp), torch.no_grad():
            done = srv.run()
        srv.assert_page_invariants()
        shapes = {f"{i}/{key}": tuple(t.shape)
                  for i, layer in enumerate(srv.cache["layers"])
                  for key, t in layer.items()}
        res = {"streams": {str(r.rid): list(map(int, r.out)) for r in done},
               "trace": srv.trace, "stats": srv.stats(), "roles": srv.roles,
               "failed": [[r.rid, r.error] for r in srv.failed],
               "fired": fp.fired,
               "spec": srv.spec.stats() if srv.spec is not None else None,
               "shapes": shapes}
        srv.drop_prefix_cache()
        srv.pool.assert_consistent()
        res["drained"] = (srv.pool.free_pages == sum(srv.pool.shares)
                          and not srv.table.any())
        out[name] = json.loads(json.dumps(res, default=_plain))
    # the graft's loss and gradient norm on the mesh
    cfg, pcfg, params, _ = _port_model(GRAFT, tmp, mesh)
    b, s = LOSS_SHAPE
    data = dict(np.load(os.path.join(tmp, "batch.npz")))
    x_spec = activation_spec((b, s, cfg.d_model), pcfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_block(data, x_spec, mesh).items()}
    opt = adamw.OptimizerConfig()
    step = steps.make_train_step(cfg, pcfg, opt, mesh=mesh,
                                 batch_shape3=(b, s, cfg.d_model))
    _, _, m = step(params, adamw.init_opt_state(params, opt), batch)
    out["graft_loss"] = {"total": float(m["total_loss"]),
                         "grad_norm": float(m["grad_norm"])}
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_paged")
    cases = {name: (m, _requests(kind, _cfg(m).vocab_size), kw, k, fl, tick)
             for name, (m, kind, kw, k, fl, tick) in CASES.items()}
    job = {"cases": cases, "models": MODELS, "hetero": HETERO,
           "slots": SLOTS, "page": PAGE, "chunk": CHUNK, "maxp": MAXP,
           "pages": PAGES,
           "loss_shape": LOSS_SHAPE}
    (tmp / "job.json").write_text(json.dumps(job))
    rng = np.random.default_rng(4)
    b, s = LOSS_SHAPE
    toks = rng.integers(0, _cfg(GRAFT).vocab_size, size=(b, s + 1))
    np.savez(tmp / "batch.npz", tokens=toks[:, :-1].astype(np.int32),
             labels=toks[:, 1:].astype(np.int32),
             loss_mask=np.ones((b, s), np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "job.json"),
         str(tmp / "jax.json"), str(tmp / "batch.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = launch_local(_port_rank, 4, str(tmp), timeout=400)
        _, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads((tmp / "jax.json").read_text()), ranks


KEYS = ("streams", "trace", "stats", "roles", "failed", "fired", "spec")


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_engine_on_a_mesh_matches_jax(results, name):
    jax_out, ranks = results
    want, got = jax_out[name], ranks[0][name]
    assert got["streams"], name
    for key in KEYS:
        assert got[key] == want[key], (name, key)
    for r in ranks:
        assert r[name]["drained"]
        for key in KEYS:
            assert r[name][key] == got[key], (name, key)


def test_cases_cross_the_data_ranks(results):
    """Slots 0-1 live on "data" rank 0 and 2-3 on rank 1: every handoff
    of the disaggregated runs crosses the ranks (Jamba's moves its Mamba
    state), the prefix cache's hits are read by slots of both ranks, the
    faults fired and the deadline failed its request."""
    _, ranks = results
    out = ranks[0]
    for name in ("disagg", "jamba"):
        moves = [e for e in out[name]["trace"] if e[0] == "transfer"]
        assert moves and all(e[2] // 2 != e[3] // 2 for e in moves), name
    for name in ("prefix", "int8"):
        # rid 0 (slot 0, "data" rank 0) prefills first and indexes the
        # system prompt's pages; a later admission on rank 1 prefills
        # fewer tokens than its prompt: it reads them
        trace, reqs = out[name]["trace"], _requests("prefix", 128)
        slot, fed = {}, {}
        for e in trace:
            if e[0] == "admit":
                slot[e[1]], fed[e[1]] = e[2], 0
            elif e[0] == "prefill_chunk":
                fed[e[1]] += e[3]
        hits = [rid for rid in fed if fed[rid] < len(reqs[rid]["prompt"])]
        assert slot[0] == 0 and any(slot[r] // 2 == 1 for r in hits), name
        assert out[name]["stats"]["prefix"]["hit_tokens"] > 0
    assert [f[2] for f in out["faults"]["fired"]] == \
        ["error", "nan", "device_drop"]
    assert ["shrink", [0]] in out["faults"]["trace"]
    assert out["preempt"]["stats"]["preemptions"] == 1
    assert out["deadline"]["failed"] and \
        "deadline" in out["deadline"]["failed"][0][1]
    # qwen's drafts are rejected and rolled back; gemma-2b's smoke weights
    # repeat a token, which the n-gram drafts propose
    assert out["spec"]["spec"]["rollback_tokens"] > 0
    assert out["gemma"]["spec"]["accepted_drafts"] > 0


def test_cache_blocks_on_each_rank(results):
    """Every rank holds every page of the pool (17 pages of 4 rows), its
    K/V heads where they split over "model" (one of qwen's two) and
    gemma-2b's one K/V head; Jamba's Mamba state holds 2 of the 4 slots
    and half the channels."""
    _, ranks = results
    for r in ranks:
        q = r["plain"]["shapes"]
        assert q["0/k"] == [PAGES, PAGE, 1, 16]
        assert r["int8"]["shapes"]["0/k_scale"] == [PAGES, PAGE, 1]
        g = r["gemma"]["shapes"]
        assert g["0/k"][:3] == [PAGES, PAGE, 1]
        jam = r["jamba"]["shapes"]
        mamba = [k for k in jam if k.endswith("/ssm")]
        assert mamba
        for k in mamba:
            full = _cfg(JAMBA).mamba.expand * _cfg(JAMBA).d_model
            assert jam[k][0] == SLOTS // 2 and jam[k][1] == full // 2


def test_graft_loss_on_the_mesh_matches_jax(results):
    jax_out, ranks = results
    for r in ranks:
        got = r["graft_loss"]
        np.testing.assert_allclose(got["total"], jax_out["graft_loss"]
                                   ["total"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], jax_out["graft_loss"]
                                   ["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", JAMBA, "xlstm-350m"])
def test_paged_cache_logical_specs_mirror_jax(arch, kv_quant):
    """The port's ``paged_cache_logical_specs`` gives, layer by layer,
    JAX's spec of the layer's period position without its leading period
    axis, one entry a dimension of the port's cache leaf, in the cache's
    tree structure."""
    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro_torch import configs as tcfglib
    from repro_torch.models import lm as tlm

    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32")
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32")
    jcache = jlm.init_paged_cache(cfg_j, num_slots=3, num_pages=9,
                                  page_size=4, kv_quant=kv_quant)
    jspecs = jlm.paged_cache_logical_specs(cfg_j, jcache)
    tcache = tlm.init_paged_cache(cfg_t, 3, 9, 4, "cpu", kv_quant=kv_quant)
    tspecs = tlm.paged_cache_logical_specs(cfg_t, tcache)
    assert tspecs["len"] == tuple(jspecs["len"])
    assert len(tspecs["layers"]) == cfg_t.num_layers
    for li, layer in enumerate(tcache["layers"]):
        spec = tspecs["layers"][li]
        want = jspecs["layers"][li % cfg_t.period]
        assert sorted(spec) == sorted(layer) == sorted(want)
        for key, t in layer.items():
            assert len(spec[key]) == t.ndim, (arch, li, key)
            assert want[key][0] is None
            assert tuple(spec[key]) == tuple(want[key][1:]), (arch, li, key)
