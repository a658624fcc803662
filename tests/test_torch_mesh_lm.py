"""PyTorch port vs the JAX package: the MoE language model on a mesh.

The port trains on gloo ranks on the CPU (``launch.mesh.launch_local``):
4 ranks on a ("data", "model") mesh of (2, 2), and 8 on a ("pod",
"data", "model") mesh of (2, 2, 2). JAX runs ``launch.steps.make_loss_fn``
and its train step on fake CPU devices, in two 8-device subprocesses for
the module run side by side (the (2, 2) meshes take the first 4 devices).
The weights are JAX's init (``split_tree(lm.init_params(PRNGKey(0),
cfg))``, carried over by ``convert.params_from_jax`` and cut by
``convert.shard_params`` under ``lm.param_specs``); the global batch (8 x
32 tokens, the first two positions masked out of the loss) is the same,
each rank holding its block of the batch dimension
(``launch.inputs.batch_block``).

Cases, all f32:
* qwen3-moe-30b-a3b's smoke config (MoE, GQA with heads that split over
  "model", untied head) in every mode: hybrid, model_centric and auto
  forced to model-centric dispatch under ag_rs and ag_ar, data_centric
  with the shared_cache and janus cache policies, auto forced to
  data-centric dispatch, and ep (capacity 8: nothing dropped);
* gemma-2b's (MQA, one K/V head, so attention takes the sequence-parallel
  branch; a tied head; embedding scale; a dense GeGLU FFN),
  phi3-medium-14b's (a dense SwiGLU decoder) and starcoder2-15b's (a
  dense MLP with biases, layer norms) in hybrid;
* qwen3-moe-30b-a3b's on the (2, 2, 2) mesh in hybrid.

Each is held to JAX's run of the same mode on the same mesh: the loss
and the logits within 1e-5 x max|ref|, aux and z within 1e-6 relative
(on a mesh both packages average each device's aux over its own rows, so
the mesh-less aux is not the reference), every gathered gradient leaf
within 1e-4 x that leaf's max|grad|. Three AdamW steps from fresh shards
give losses within 2e-3 of JAX's mesh-less run (the limit JAX's own test
gives between its mesh and mesh-less runs, ``tests/test_distributed.py``),
and qwen's hybrid ones of JAX's mesh run too. Measured: up to 1.3e-3 from
the mesh-less run (JAX's own mesh run is 1.5e-3 from it: the aux losses
differ on a mesh) and 2.5e-4 from JAX's mesh run, the first step's
gradients agreeing within 1.3e-6 x max|grad|: Adam's normalised update
magnifies the last bits of the smallest gradients. The first step's clip
norm, which each rank sums from its own blocks, is the gathered
gradient's norm within 1e-5 relative and JAX's within 1e-4. ``convert.shard_params`` of the carried tree and
``shard_opt_state`` of a JAX-layout AdamW state gather back to the JAX
arrays bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 32
LOSS_TOL, AUX_RTOL, GRAD_TOL, STEPS_TOL = 1e-5, 1e-6, 1e-4, 2e-3
NORM_RTOL = 1e-5
OPT = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=10, master_fp32=False)
QWEN, GEMMA, PHI3 = "qwen3-moe-30b-a3b", "gemma-2b", "phi3-medium-14b"
STAR = "starcoder2-15b"
MESH4 = ((2, 2), ("data", "model"))
MESH8 = ((2, 2, 2), ("pod", "data", "model"))

# (name, arch, mesh, mode, schedule, forced_layer_mode, cache_policy)
CASES = [
    *[(f"qwen-{m}-{s}", QWEN, MESH4, mode, s, f, "shared_cache")
      for m, mode, f in (("hybrid", "hybrid", None),
                         ("model", "model_centric", None),
                         ("auto_mc", "auto", "model_centric"))
      for s in ("ag_rs", "ag_ar")],
    ("qwen-data-shared", QWEN, MESH4, "data_centric", "ag_rs", None,
     "shared_cache"),
    ("qwen-data-janus", QWEN, MESH4, "data_centric", "ag_rs", None, "janus"),
    ("qwen-auto_dc", QWEN, MESH4, "auto", "ag_rs", "data_centric",
     "shared_cache"),
    ("qwen-ep", QWEN, MESH4, "ep", "ag_rs", None, "none"),
    ("gemma-hybrid", GEMMA, MESH4, "hybrid", "ag_rs", None, "shared_cache"),
    ("phi3-hybrid", PHI3, MESH4, "hybrid", "ag_rs", None, "shared_cache"),
    ("starcoder2-hybrid", STAR, MESH4, "hybrid", "ag_rs", None,
     "shared_cache"),
    ("qwen3d-hybrid", QWEN, MESH8, "hybrid", "ag_rs", None, "shared_cache"),
]
NAMES = [c[0] for c in CASES]


def _ref_key(case):
    """JAX's reference run of a case: its schedule and cache policy change
    no value, so cases differing only there share one."""
    name, arch, mesh, mode, _, forced, _ = case
    return f"{arch}|{len(mesh[0])}|{mode}|{forced}"


REFS = sorted({_ref_key(c): c for c in CASES}.items())


def _logits_key(case):
    """JAX's logits of an architecture on a mesh, from one mode's run:
    the modes change the aux losses, not the logits."""
    return f"{case[1]}|{len(case[2][0])}/logits"


def _jax_jobs():
    """JAX's work, split over two subprocesses run side by side: a
    gradient (and, once an architecture and mesh, logits) run of each
    reference, three mesh-less train steps of each architecture and three
    on the mesh for qwen's hybrid."""
    jobs, seen = [], set()
    for key, c in REFS:
        lk = _logits_key(c)
        jobs.append(("grad", key, c[1], len(c[2][0]), c[3], c[5],
                     lk not in seen))
        seen.add(lk)
    jobs.append(("steps_mesh", _ref_key(CASES[0]), QWEN, 2, "hybrid", None,
                 False))
    jobs += [("steps_plain", "", a, 0, "", None, False)
             for a in (QWEN, GEMMA, PHI3, STAR)]
    return jobs[0::2], jobs[1::2]


def _cfg(arch):
    import dataclasses

    from repro_torch import configs as cfglib

    return dataclasses.replace(cfglib.get_smoke_config(arch), dtype="float32")


def _batch(vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, :2] = 0.0
    return {"tokens": toks, "labels": np.roll(toks, -1, 1).astype(np.int32),
            "loss_mask": mask}


def _nest(flat: dict):
    """A nested dict/list tree from "a/0/b"-keyed leaves."""
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


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


def _sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


JAX_SCRIPT = r"""
import json, sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs as cfglib
from repro.launch import steps as steps_lib
from repro.launch.inputs import activation_spec
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.optim import adamw
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings

jobs = json.loads(sys.argv[1])
opt = json.loads(sys.argv[2])
data = np.load(sys.argv[3])
B, S = %(b)d, %(s)d
mesh8 = make_mesh((2, 2, 2), ("pod", "data", "model"))
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(leaf)

def place(params, specs, pcfg, mesh):
    return jax.tree.map(jax.device_put, params,
                        tree_shardings(params, specs, pcfg, mesh))

def train3(cfg, params, pcfg, mesh, batch):
    opt_cfg = adamw.OptimizerConfig(**opt)
    step = jax.jit(steps_lib.make_train_step(cfg, pcfg, mesh, opt_cfg,
                                             (B, S, cfg.d_model)))
    state = adamw.init_opt_state(params, opt_cfg)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return np.asarray(losses)

for kind, key, arch, ndim, mode, forced, logits_too in jobs:
    cfg = dataclasses.replace(cfglib.get_smoke_config(arch), dtype="float32")
    params, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
    batch = {k: jnp.asarray(data[arch + "/" + k])
             for k in ("tokens", "labels", "loss_mask")}
    if kind == "steps_plain":
        out[arch + "/steps_plain"] = train3(cfg, params,
                                            ParallelConfig(blk=8), None, batch)
        continue
    mesh = mesh8 if ndim == 3 else mesh4
    pcfg = ParallelConfig(mode=mode, blk=8, capacity_factor=8.0,
                          forced_layer_mode=forced)
    shape3 = (B, S, cfg.d_model)
    with mesh:
        pp = place(params, specs, pcfg, mesh)
        if kind == "steps_mesh":
            out[key + "/steps"] = train3(cfg, pp, pcfg, mesh, batch)
            continue
        lf = steps_lib.make_loss_fn(cfg, pcfg, mesh, shape3)
        (total, m), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            pp, batch)
        if logits_too:
            out[arch + "|" + str(ndim) + "/logits"] = np.asarray(jax.jit(
                lambda p: lm.forward(
                    p, batch, cfg, pcfg, mesh, mode="train",
                    x_spec=activation_spec(shape3, pcfg, mesh))[0])(pp))
    out[key + "/total"] = np.asarray(total)
    for k in ("loss", "aux_loss", "z_loss"):
        out[key + "/" + k] = np.asarray(m[k])
    flat(g, key + "/g/")
np.savez(sys.argv[4], **out)
print("RESULT ok")
""" % dict(b=B, s=S)


def _port_rank(rank, cases, tmp):
    """One rank: for each case the loss, aux, z, logits and gathered
    gradient of ``make_loss_fn`` on the mesh, then three train steps from
    fresh shards."""
    import dataclasses

    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.convert import (
        opt_state_from_jax,
        params_from_jax,
        shard_opt_state,
        shard_params,
    )
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig, unshard_tree

    data = dict(np.load(os.path.join(tmp, "in.npz")))
    out = {}
    shape, axes = cases[0][2]
    mesh = make_mesh(shape, axes)
    opt_cfg = adamw.OptimizerConfig(**OPT)
    for name, arch, _, mode, sched, forced, policy in cases:
        cfg = _cfg(arch)
        jtree = _nest(_sub(data, arch + "/p/"))
        tree = params_from_jax(jtree, cfg, device="cpu")
        batch = {k: torch.from_numpy(data[f"{arch}/{k}"])
                 for k in ("tokens", "labels", "loss_mask")}
        pcfg = ParallelConfig(mode=mode, collective_schedule=sched, blk=8,
                              forced_layer_mode=forced, cache_policy=policy,
                              capacity_factor=8.0)
        shape3 = (B, S, cfg.d_model)
        x_spec = activation_spec(shape3, pcfg, mesh)
        lb = batch_block(batch, x_spec, mesh)
        specs = lm.param_specs(cfg, pcfg)
        shapes = lm.param_shapes(cfg)
        # the JAX tree's blocks, carried over and gathered back, and a
        # JAX-layout AdamW state's (moments made from the weights)
        jstate = {"m": _tmap(lambda a: a * 0.5, jtree),
                  "v": _tmap(lambda a: a * a, jtree), "step": np.int32(3)}
        st = shard_opt_state(opt_state_from_jax(jstate, cfg, device="cpu"),
                             specs, pcfg, mesh, device="cpu")
        shard_err = 0.0
        for got, want in ((shard_params(tree, specs, pcfg, mesh,
                                        device="cpu"), tree),
                          (st["m"], _tmap(lambda a: a * 0.5, tree)),
                          (st["v"], _tmap(lambda a: a * a, tree))):
            full = unshard_tree(got, specs, shapes, pcfg, mesh)
            shard_err = max([shard_err] + [
                float((a - b).abs().max())
                for a, b in zip(tree_leaves(full), tree_leaves(want))])
        p = shard_params(tree, specs, pcfg, mesh, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        loss_fn = steps.make_loss_fn(cfg, pcfg, mesh=mesh,
                                     batch_shape3=shape3)
        total, m = loss_fn(p, lb)
        grads = torch.autograd.grad(total, leaves)
        it = iter(grads)
        gfull = unshard_tree(tree_map(lambda _: next(it), p), specs,
                             shapes, pcfg, mesh)
        with torch.no_grad():
            logits, _, _, _ = lm.forward(p, lb, cfg, pcfg, mode="train",
                                         mesh=mesh, x_spec=x_spec)
        logits = mesh.all_gather(logits, x_spec[0], 0)
        # three AdamW steps from fresh shards
        p = shard_params(tree, specs, pcfg, mesh, device="cpu")
        state = steps.sharded_opt_state(p, opt_cfg)
        step = steps.make_train_step(cfg, pcfg, opt_cfg, mesh=mesh,
                                     batch_shape3=shape3)
        losses, norms = [], []
        for _ in range(3):
            p, state, sm = step(p, state, lb)
            losses.append(float(sm["loss"]))
            norms.append(float(sm["grad_norm"]))
        if rank == 0:
            out[name] = {
                "total": float(total), "loss": float(m["loss"]),
                "aux_loss": float(m["aux_loss"]),
                "z_loss": float(m["z_loss"]), "logits": logits.numpy(),
                "grads": [t.numpy() for t in tree_leaves(gfull)],
                "steps": np.asarray(losses), "grad_norm": norms[0],
                "state_step": int(state["step"]), "shard_err": shard_err,
                "opt_step": int(st["step"])}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    tmp = tmp_path_factory.mktemp("mesh_lm")
    arrays = {}
    for arch in (QWEN, GEMMA, PHI3, STAR):
        cfg = _cfg(arch)
        jcfg = jcfglib.get_smoke_config(arch)
        import dataclasses

        jcfg = dataclasses.replace(jcfg, dtype="float32")
        params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            arrays[f"{arch}/p/{key}"] = np.asarray(leaf)
        arrays.update({f"{arch}/{k}": v
                       for k, v in _batch(cfg.vocab_size).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(jobs), json.dumps(OPT),
         str(tmp / "in.npz"), str(tmp / f"jax{i}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i, jobs in enumerate(_jax_jobs())]
    try:
        port = {}
        for mesh, world in ((MESH4, 4), (MESH8, 8)):
            cases = [c for c in CASES if c[2] == mesh]
            port.update(launch_local(_port_rank, world, cases, str(tmp),
                                     timeout=240)[0])
        errs = [proc.communicate(timeout=400)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-3000:]
    jax_out = {}
    for i in range(len(procs)):
        jax_out.update(np.load(tmp / f"jax{i}.npz"))
    return jax_out, port


def _jax_grads(jax_out, case):
    from repro_torch.common import tree_leaves
    from repro_torch.convert import params_from_jax

    tree = _nest(_sub(jax_out, _ref_key(case) + "/g/"))
    return [t.numpy() for t in tree_leaves(
        params_from_jax(tree, _cfg(case[1]), device="cpu"))]


def _close(got, want, tol_rel, what):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol_rel * scale, (what, err, scale)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_lm_mesh_loss_logits_and_aux_match_jax(results, case):
    jax_out, port = results
    r, key = port[case[0]], _ref_key(case)
    _close(r["loss"], jax_out[key + "/loss"], LOSS_TOL, "loss")
    _close(r["total"], jax_out[key + "/total"], LOSS_TOL, "total")
    _close(r["logits"], jax_out[_logits_key(case)], LOSS_TOL, "logits")
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(r[k], float(jax_out[f"{key}/{k}"]),
                                   rtol=AUX_RTOL, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_lm_mesh_grads_match_jax(results, case):
    jax_out, port = results
    got, want = port[case[0]]["grads"], _jax_grads(jax_out, case)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        _close(a, b, GRAD_TOL, f"grad leaf {i}")


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_lm_mesh_three_steps_match_jax(results, case):
    jax_out, port = results
    r = port[case[0]]
    assert r["state_step"] == 3
    np.testing.assert_allclose(r["steps"], jax_out[case[1] + "/steps_plain"],
                               rtol=0, atol=STEPS_TOL)
    mesh_steps = jax_out.get(_ref_key(case) + "/steps")
    if mesh_steps is not None:
        np.testing.assert_allclose(r["steps"], mesh_steps, rtol=0,
                                   atol=STEPS_TOL)


def _global_norm(leaves):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(a, np.float64)))
                             for a in leaves)))


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_lm_mesh_clip_norm_is_the_global_norm(results, case):
    """``sharding.global_grad_norm`` sums each leaf's squares over the
    axes its block is sharded on and counts a replicated leaf once: the
    first step's ``grad_norm`` is the whole gradient tree's."""
    jax_out, port = results
    r = port[case[0]]
    np.testing.assert_allclose(r["grad_norm"], _global_norm(r["grads"]),
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(r["grad_norm"],
                               _global_norm(_jax_grads(jax_out, case)),
                               rtol=GRAD_TOL)


#: The other LM families, cut as ``test_torch_mesh_recurrent.py`` cuts
#: them: (name, arch, config overrides, mode) on the (2, 2) mesh.
FAMILY_CASES = [
    ("jamba-hybrid", "jamba-1.5-large-398b",
     {"num_layers": 2, "layer_pattern": ("mamba", "attn")}, "hybrid"),
    ("jamba-data", "jamba-1.5-large-398b",
     {"num_layers": 2, "layer_pattern": ("mamba", "attn")}, "data_centric"),
    ("xlstm-hybrid", "xlstm-350m",
     {"num_layers": 2, "layer_pattern": ("mlstm", "slstm")}, "hybrid"),
    ("paligemma-hybrid", "paligemma-3b", {}, "hybrid"),
    ("musicgen-hybrid", "musicgen-large", {}, "hybrid"),
]


def _family_shard_rank(rank, cases, tmp):
    """``shard_params`` and ``shard_opt_state`` of each family's JAX tree,
    gathered back: the largest difference from the JAX arrays."""
    import dataclasses

    from repro_torch import configs as cfglib
    from repro_torch.common import tree_leaves
    from repro_torch.convert import (
        opt_state_from_jax,
        params_from_jax,
        shard_opt_state,
        shard_params,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig, unshard_tree

    data = dict(np.load(os.path.join(tmp, "fam.npz")))
    mesh = make_mesh(*MESH4)
    out = {}
    for name, arch, cut, mode in cases:
        cfg = dataclasses.replace(cfglib.get_smoke_config(arch),
                                  dtype="float32", **cut)
        jtree = _nest(_sub(data, arch + "/"))
        tree = params_from_jax(jtree, cfg, device="cpu")
        pcfg = ParallelConfig(mode=mode)
        specs = lm.param_specs(cfg, pcfg)
        shapes = lm.param_shapes(cfg)
        jstate = {"m": _tmap(lambda a: a * 0.5, jtree),
                  "v": _tmap(lambda a: a * a, jtree), "step": np.int32(3)}
        st = shard_opt_state(opt_state_from_jax(jstate, cfg, device="cpu"),
                             specs, pcfg, mesh, device="cpu")
        err = 0.0
        for got, want in ((shard_params(tree, specs, pcfg, mesh,
                                        device="cpu"), tree),
                          (st["m"], _tmap(lambda a: a * 0.5, tree)),
                          (st["v"], _tmap(lambda a: a * a, tree))):
            full = unshard_tree(got, specs, shapes, pcfg, mesh)
            err = max([err] + [float((a - b).abs().max()) for a, b in
                               zip(tree_leaves(full), tree_leaves(want))])
        out[name] = {"shard_err": err, "opt_step": int(st["step"])}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def family_shards(tmp_path_factory):
    import dataclasses

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    tmp = tmp_path_factory.mktemp("mesh_lm_fam")
    arrays = {}
    for _, arch, cut, _ in FAMILY_CASES:
        jcfg = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                   dtype="float32", **cut)
        params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            arrays[f"{arch}/{key}"] = np.asarray(leaf)
    np.savez(tmp / "fam.npz", **arrays)
    return launch_local(_family_shard_rank, 4, FAMILY_CASES, str(tmp),
                        timeout=240)[0]


@pytest.mark.parametrize("case", CASES + FAMILY_CASES,
                         ids=NAMES + [c[0] for c in FAMILY_CASES])
def test_lm_shard_params_and_opt_state_gather_to_jax(request, case):
    """``convert.shard_params`` of ``params_from_jax``'s tree and
    ``shard_opt_state`` of ``opt_state_from_jax``'s, under
    ``lm.param_specs`` and the case's mode: every rank's blocks, gathered,
    are the JAX arrays bit for bit; the step count is kept. The other
    families' cases (Mamba, mLSTM, sLSTM, cross-attention, frontend and
    codebook-head leaves) shard their JAX trees alone."""
    if case in FAMILY_CASES:
        r = request.getfixturevalue("family_shards")[case[0]]
    else:
        r = request.getfixturevalue("results")[1][case[0]]
    assert r["shard_err"] == 0.0
    assert r["opt_step"] == 3
