"""PyTorch port vs the JAX package: serving the LM on a mesh.

The port runs on 4 gloo ranks on the CPU (``launch.mesh.launch_local``, a
("data", "model") mesh of (2, 2)); JAX's dense engine on a mesh of the
same shape over 4 fake CPU devices in one subprocess for the module.
Weights: JAX's init of the f32 smoke configs
(``split_tree(lm.init_params(PRNGKey(0), cfg))``), carried over by
``convert.params_from_jax`` and cut by ``convert.shard_params`` under
``lm.param_specs``.

* the pipeline-shared prefetch cache on the mesh (hybrid and auto): the
  dense prefill and three decode steps with ``cache_layers`` 2 give logits
  bit for bit those with ``cache_layers`` 0, with at most 2 resident
  layers and a hit on every layer after the first (JAX's
  ``tests/test_autotune.py::test_unrolled_cache_path_bitwise_equals_
  uncached``); likewise without a mesh;
* no cache is built under the remat'd training forward, one is under
  ``remat="none"``, and the loss is the same bit for bit
  (``test_cache_skipped_under_remat_train_and_rejected_with_scan``; the
  port's loop is always unrolled, so the scan half has no counterpart);
* ``BatchedServer`` (4 slots, 6 greedy requests, so slots are reused) on
  the mesh: qwen3-moe-30b-a3b's smoke config (heads split over "model")
  gives the tokens of the mesh-less port and of JAX's dense engine on the
  same mesh, and its gathered cache is theirs within 1e-5 x max|ref|
  (lengths exactly); gemma-2b's (MQA: K/V heads replicated) the mesh-less
  port's; ``reference_stream`` on the mesh the mesh-less one's;
* token ids outside the vocabulary read the rows JAX's gather reads
  (wrapped once if negative, then clamped), through the
  vocabulary-parallel embedding on the mesh;
* what the steps take on a mesh: every model part, the paged engine's
  steps, the "node" axis, ``overlap_dispatch`` and router statistics;
  the "ep" mode on a node mesh stays refused.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_TOL = 1e-5
QWEN, GEMMA = "qwen3-moe-30b-a3b", "gemma-2b"
SLOTS, MAX_SEQ, MAX_NEW = 4, 16, 4
PROMPT_LENS = (5, 6, 4, 5, 3, 6)


def _cfg(arch):
    import dataclasses

    from repro_torch import configs as cfglib

    return dataclasses.replace(cfglib.get_smoke_config(arch), dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _flat_paths(tree, prefix, out):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(leaf)


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


def _jax_ids(ids, vocab):
    """Where JAX's ``emb[ids]`` reads: negative ids wrap once, then every
    id clamps into the table."""
    return np.clip(np.where(ids < 0, ids + vocab, ids), 0, vocab - 1)


def _params(data, arch):
    from repro_torch.convert import params_from_jax

    pre = arch + "/p/"
    return params_from_jax(
        _nest({k[len(pre):]: v for k, v in data.items()
               if k.startswith(pre)}), _cfg(arch), device="cpu")


JAX_SCRIPT = r"""
import json, sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as cfglib
from repro.launch.mesh import make_mesh
from repro.launch.serve import BatchedServer, Request
from repro.models import lm
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings

data = np.load(sys.argv[1])
cfg = dataclasses.replace(cfglib.get_smoke_config("%(qwen)s"),
                          dtype="float32")
params, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
mesh = make_mesh((2, 2), ("data", "model"))
pcfg = ParallelConfig(mode="hybrid", blk=8)
out = {}
with mesh:
    params = jax.tree.map(jax.device_put, params,
                          tree_shardings(params, specs, pcfg, mesh))
    srv = BatchedServer(cfg, pcfg, mesh, num_slots=%(slots)d,
                        max_seq=%(max_seq)d, params=params)
    n = int(data["n_prompts"])
    for i in range(n):
        srv.submit(Request(rid=i, prompt=data["prompt/%%d" %% i],
                           max_new=%(max_new)d))
    done = srv.run()
for r in done:
    out["tokens/%%d" %% r.rid] = np.asarray(r.out, np.int32)
for i, layer in enumerate(srv.cache["layers"]):
    for k, v in layer.items():
        out["cache/%%d/%%s" %% (i, k)] = np.asarray(v)
out["cache_len"] = np.asarray(srv.cache["len"])
np.savez(sys.argv[2], **out)
print("RESULT ok")
""" % dict(qwen=QWEN, slots=SLOTS, max_seq=MAX_SEQ, max_new=MAX_NEW)


def _port_rank(rank, tmp):
    """One rank: the prefetch cache's decode logits and stats, the remat
    skip, and the dense engine on the mesh and without it."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.convert import shard_params
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import (
        BatchedServer,
        Request,
        reference_stream,
    )
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    data = dict(np.load(os.path.join(tmp, "in.npz")))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}

    # -- the pipeline-shared cache on the decode path --------------------
    cfg = _cfg(QWEN)
    full = _params(data, QWEN)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 8)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 4, 1)))

    def decode_logits(pcfg, m):
        p = full if m is None else shard_params(
            full, lm.param_specs(cfg, pcfg), pcfg, m, device="cpu")
        pre = steps.make_prefill_step(cfg, pcfg, mesh=m,
                                      batch_shape3=(4, 8, cfg.d_model))
        dec = steps.make_serve_step(cfg, pcfg, mesh=m,
                                    batch_shape3=(4, 1, cfg.d_model))
        cache = lm.init_cache(cfg, 4, 16, "cpu", pcfg=pcfg, mesh=m)
        lm.LAST_PIPELINE_CACHE_STATS = None
        with torch.no_grad():
            logits, cache = pre(p, {"tokens": toks}, cache)
            outs = [logits]
            for t in nxt:
                logits, cache = dec(p, {"tokens": t}, cache)
                outs.append(logits)
        return torch.cat(outs, 1).numpy(), lm.LAST_PIPELINE_CACHE_STATS

    for mode in ("hybrid", "auto"):
        for m, tag in ((mesh, "mesh"), (None, "plain")):
            base, st0 = decode_logits(ParallelConfig(mode=mode, blk=8), m)
            cached, st = decode_logits(
                ParallelConfig(mode=mode, blk=8, cache_layers=2), m)
            out[f"cache/{mode}/{tag}"] = {
                "bitwise": bool(np.array_equal(base, cached)),
                "stats_off": st0, "stats": st, "logits": base}

    # -- ids outside the vocabulary: wrapped and clamped, as JAX gathers --
    pcfg = ParallelConfig(blk=8)
    bad = torch.tensor([[-1, -200, 5, cfg.vocab_size - 1, cfg.vocab_size,
                         1000, 7, 3]] * 4)
    x_spec = activation_spec((4, 8, cfg.d_model), pcfg, mesh)
    p = shard_params(full, lm.param_specs(cfg, pcfg), pcfg, mesh,
                     device="cpu")
    with torch.no_grad():
        got, _, _, _ = lm.forward(p, batch_block({"tokens": bad}, x_spec,
                                                 mesh), cfg, pcfg,
                                  mode="train", mesh=mesh, x_spec=x_spec)
        want, _, _, _ = lm.forward(full, {"tokens": torch.from_numpy(
            _jax_ids(bad.numpy(), cfg.vocab_size))}, cfg, pcfg, mode="train")
    out["oov"] = (mesh.all_gather(got, x_spec[0], 0).numpy(), want.numpy())

    # -- remat'd train forward: no cache ---------------------------------
    b = {"tokens": toks.int(), "labels": torch.roll(toks, -1, 1).int(),
         "loss_mask": torch.ones(4, 8)}
    remat = {}
    for r in ("block", "none"):
        for layers in (0, 2):
            pcfg = ParallelConfig(blk=8, remat=r, cache_layers=layers)
            p = shard_params(full, lm.param_specs(cfg, pcfg), pcfg, mesh,
                             device="cpu")
            x_spec = activation_spec((4, 8, cfg.d_model), pcfg, mesh)
            lm.LAST_PIPELINE_CACHE_STATS = None
            leaves = [t.requires_grad_() for t in tree_leaves(p)]
            total, _ = steps.make_loss_fn(
                cfg, pcfg, mesh=mesh, batch_shape3=(4, 8, cfg.d_model))(
                p, batch_block(b, x_spec, mesh))
            grads = torch.autograd.grad(total, leaves)
            remat[(r, layers)] = (float(total),
                                  lm.LAST_PIPELINE_CACHE_STATS,
                                  [g.numpy() for g in grads])
    out["remat"] = remat

    # -- the dense engine --------------------------------------------------
    for arch in (QWEN, GEMMA):
        cfg = _cfg(arch)
        full = _params(data, arch)
        pcfg = ParallelConfig(mode="hybrid", blk=8)
        sharded = shard_params(full, lm.param_specs(cfg, pcfg), pcfg, mesh,
                               device="cpu")
        res = {}
        for tag, m, p in (("mesh", mesh, sharded), ("plain", None, full)):
            srv = BatchedServer(cfg, pcfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                                params=p, device="cpu", mesh=m)
            for i, pr in enumerate(_prompts(cfg.vocab_size)):
                srv.submit(Request(rid=i, prompt=pr, max_new=MAX_NEW))
            with torch.no_grad():
                done = srv.run()
            cache = srv.cache
            if m is not None:
                cache = lm.gather_cache(cache, lm.cache_specs(
                    cfg, pcfg, m, SLOTS, MAX_SEQ), m)
            res[tag] = {"tokens": {r.rid: list(r.out) for r in done},
                        "cache": tree_map(lambda t: t.numpy(), cache),
                        "kv_bytes": srv.kv_bytes()}
        with torch.no_grad():
            pr = _prompts(cfg.vocab_size)[0]
            res["ref_mesh"] = reference_stream(
                cfg, pcfg, sharded, Request(rid=0, prompt=pr, max_new=5),
                max_seq=MAX_SEQ, mesh=mesh)
            res["ref_plain"] = reference_stream(
                cfg, pcfg, full, Request(rid=0, prompt=pr, max_new=5),
                max_seq=MAX_SEQ)
        out[f"serve/{arch}"] = res
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    tmp = tmp_path_factory.mktemp("mesh_lm_serve")
    arrays = {}
    for arch in (QWEN, GEMMA):
        jcfg = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                   dtype="float32")
        params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        _flat_paths(params, arch + "/p/", arrays)
    prompts = _prompts(_cfg(QWEN).vocab_size)
    arrays.update({f"prompt/{i}": p for i, p in enumerate(prompts)})
    arrays["n_prompts"] = np.asarray(len(prompts))
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 4, str(tmp), timeout=240)[0]
        _, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "jax.npz")), port


@pytest.mark.parametrize("mode", ["hybrid", "auto"])
@pytest.mark.parametrize("where", ["mesh", "plain"])
def test_prefetch_cache_decode_is_bitwise_the_uncached(results, mode, where):
    _, port = results
    r = port[f"cache/{mode}/{where}"]
    assert r["bitwise"]
    assert r["stats_off"] is None          # cache_layers 0 builds none
    st = r["stats"]
    assert st is not None
    assert st["peak_resident_layers"] <= 2
    assert st["hits"] > 0                  # the prefetch made it a hit
    assert np.isfinite(r["logits"]).all()


def test_prefetch_cache_mesh_logits_match_the_meshless(results):
    _, port = results
    for mode in ("hybrid", "auto"):
        a = port[f"cache/{mode}/mesh"]["logits"]
        b = port[f"cache/{mode}/plain"]["logits"]
        assert np.abs(a - b).max() <= CACHE_TOL * np.abs(b).max()


def test_out_of_vocabulary_ids_read_as_jax_reads_them(results):
    """The vocabulary-parallel embedding on the mesh takes an id outside
    the table where JAX's gather takes it (``_jax_ids``, held to
    ``jnp``'s indexing here), not to a zero row."""
    import jax.numpy as jnp

    ids = np.array([-1, -200, 5, 127, 128, 1000, 7, 3])
    assert np.array_equal(np.asarray(jnp.arange(128)[jnp.asarray(ids)]),
                          _jax_ids(ids, 128))
    _, port = results
    got, want = port["oov"]
    assert np.abs(got - want).max() <= CACHE_TOL * np.abs(want).max()


def test_cache_skipped_under_remat_train(results):
    _, port = results
    remat = port["remat"]
    for layers in (0, 2):
        assert remat[("block", layers)][1] is None
    assert remat[("none", 0)][1] is None
    st = remat[("none", 2)][1]
    assert st is not None and st["peak_resident_layers"] <= 2
    ref = remat[("block", 0)]
    for key in (("block", 2), ("none", 0), ("none", 2)):
        assert remat[key][0] == ref[0], key
        for a, b in zip(remat[key][2], ref[2]):
            assert np.abs(a - b).max() <= 1e-6 * (np.abs(b).max() or 1), key


@pytest.mark.parametrize("arch", [QWEN, GEMMA])
def test_batched_server_on_mesh_matches_meshless(results, arch):
    _, port = results
    r = port[f"serve/{arch}"]
    assert r["mesh"]["tokens"] == r["plain"]["tokens"]
    assert len(r["mesh"]["tokens"]) == len(PROMPT_LENS)
    mesh_c, plain_c = r["mesh"]["cache"], r["plain"]["cache"]
    np.testing.assert_array_equal(mesh_c["len"], plain_c["len"])
    for a, b in zip(mesh_c["layers"], plain_c["layers"]):
        for k in b:
            assert np.abs(a[k] - b[k]).max() <= CACHE_TOL * np.abs(b[k]).max()
    # each rank holds half the slots, and with heads that split, half the
    # K/V heads: a quarter (qwen) or a half (gemma's one K/V head)
    share = 4 if arch == QWEN else 2
    assert r["mesh"]["kv_bytes"] * share == r["plain"]["kv_bytes"]
    assert r["ref_mesh"] == r["ref_plain"]


def test_batched_server_on_mesh_matches_jax(results):
    jax_out, port = results
    r = port[f"serve/{QWEN}"]["mesh"]
    for rid, toks in r["tokens"].items():
        assert toks == jax_out[f"tokens/{rid}"].tolist(), rid
    np.testing.assert_array_equal(r["cache"]["len"], jax_out["cache_len"])
    n_layers = len(r["cache"]["layers"])
    for i in range(n_layers):
        for k in ("k", "v"):
            want = jax_out[f"cache/0/{k}"][i]      # period 1: stacked
            got = r["cache"]["layers"][i][k]
            assert np.abs(got - want).max() <= CACHE_TOL * np.abs(want).max()


class _FakeMesh:
    """Enough of a mesh to build the steps and reach the refusals, which
    come before any collective."""

    def __init__(self, axes=("data", "model")):
        self.axis_names = axes
        self.shape = {a: 2 for a in axes}

    def size(self, axes):
        from repro_torch.parallel.sharding import as_axes

        return int(np.prod([self.shape[a] for a in as_axes(axes)]))

    def index(self, axes):
        return 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m",
                                  "musicgen-large", "paligemma-3b"])
def test_model_parts_on_a_mesh_are_refused(arch):
    """The recurrent mixers, cross-attention, frontends and codebook heads
    run on a mesh now (``test_torch_mesh_recurrent.py``,
    ``test_torch_mesh_frontends.py``): their steps build on one, and so
    does a train step with router statistics, refused on a mesh until the
    port's router stats (``test_torch_mesh_obs.py`` holds their counts to
    JAX's on a (2, 2) mesh)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = _cfg(arch)
    lm.check_mesh(cfg, ParallelConfig(), _FakeMesh())
    steps.make_train_step(cfg, ParallelConfig(), adamw.OptimizerConfig(),
                          mesh=_FakeMesh(), batch_shape3=(4, 8, 64))
    step = steps.make_train_step(cfg, ParallelConfig(
        collect_router_stats=True), adamw.OptimizerConfig(), mesh=_FakeMesh(),
        batch_shape3=(4, 8, 64))
    assert callable(step)


def test_paged_engine_node_axis_and_overlap_on_a_mesh_are_refused():
    """The paged engine's steps build on a mesh, a "node" mesh and with
    ``overlap_dispatch`` (``test_torch_mesh_paged.py`` runs them); so do
    the dense steps. What stays refused: the "ep" mode on a node mesh, as
    JAX's is, and a paged forward whose sequence is split."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = _cfg(QWEN)
    node = _FakeMesh(("data", "node", "model"))
    for m in (_FakeMesh(), node):
        steps.make_paged_serve_step(cfg, ParallelConfig(), 4, mesh=m,
                                    num_slots=4)
        steps.make_paged_prefill_step(cfg, ParallelConfig(), 4, mesh=m,
                                      num_slots=4)
        steps.make_paged_score_step(cfg, ParallelConfig(), 4, mesh=m)
        steps.make_paged_handoff_step(cfg, ParallelConfig(), mesh=m,
                                      num_slots=4)
    with pytest.raises(ValueError, match="num_slots"):
        steps.make_paged_serve_step(cfg, ParallelConfig(), 4,
                                    mesh=_FakeMesh())
    with pytest.raises(ValueError, match="whole sequences"):
        lm.forward({}, {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
                   cfg, ParallelConfig(), mode="decode", mesh=_FakeMesh(),
                   x_spec=(None, "model", None),
                   paged={"table": None, "page_size": 4})
    steps.make_serve_step(cfg, ParallelConfig(), mesh=node,
                          batch_shape3=(4, 1, 64))
    with pytest.raises(NotImplementedError, match="two-level \\(node\\)"):
        steps.make_serve_step(cfg, ParallelConfig(mode="ep"), mesh=node,
                              batch_shape3=(4, 1, 64))
    with pytest.raises(NotImplementedError, match="two-level \\(node\\)"):
        steps.make_paged_serve_step(cfg, ParallelConfig(mode="ep"), 4,
                                    mesh=node, num_slots=4)
    steps.make_serve_step(cfg, ParallelConfig(overlap_dispatch=True,
                                              cache_layers=2),
                          mesh=_FakeMesh(), batch_shape3=(4, 1, 64))
    steps.make_paged_serve_step(cfg, ParallelConfig(overlap_dispatch=True,
                                                    cache_layers=2), 4,
                                mesh=_FakeMesh(), num_slots=4)
