"""PyTorch port vs the JAX package: the recurrent stacks on a mesh.

4 gloo ranks on a ("data", "model") mesh of (2, 2) against JAX's GSPMD
run on 4 fake CPU devices (one subprocess, started while the ranks run),
in hybrid, f32, from JAX's init carried over by
``convert.params_from_jax`` and cut by ``convert.shard_params``:

* jamba-1.5-large-398b's smoke config cut to a 2-layer period, a Mamba
  layer with its dense FFN and an attention layer with its MoE FFN
  (``layer_pattern=("mamba", "attn")``): Mamba splits its inner channels
  over "model";
* xlstm-350m's cut to an mLSTM and an sLSTM layer (the cells run
  replicated over "model", as JAX constrains them).

Each is held to JAX's mesh run: the loss and the logits within 1e-5 x
max|ref|, aux and z within 1e-6 relative, every gathered gradient leaf
within 1e-4 x its max|grad|. The dense steps (a prefill of 4 x 8 tokens
and 3 decodes) on the mesh give the mesh-less steps' greedy tokens and
logits within 1e-5 x max|ref|; the xLSTM states of the decode cache,
which every "model" rank of a batch block holds whole, are equal bit for
bit across those ranks, and a Mamba layer's are its channel blocks of
the mesh-less state.

``test_torch_mesh_frontends.py`` runs paligemma-3b and musicgen-large
through this harness.
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
B, S = 4, 16
LOSS_TOL, AUX_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"
#: each architecture's cut: two layers, one period
CUTS = {JAMBA: {"num_layers": 2, "layer_pattern": ["mamba", "attn"]},
        XLSTM: {"num_layers": 2, "layer_pattern": ["mlstm", "slstm"]}}
DECODE = (JAMBA, XLSTM)


def cfg_of(arch, cuts):
    import dataclasses

    from repro_torch import configs as cfglib

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cuts[arch].items()}
    return dataclasses.replace(cfglib.get_smoke_config(arch),
                               dtype="float32", **kw)


def batch_of(cfg):
    """The global batch: seeded tokens, made into the frontend's inputs
    as the train CLI makes them (``launch.train.frontend_batch``)."""
    from repro_torch.launch.train import frontend_batch

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, :2] = 0.0
    return frontend_batch(cfg, {"tokens": toks,
                                "labels": np.roll(toks, -1, 1).astype(
                                    np.int32), "loss_mask": mask}, 0)


JAX_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs as cfglib
from repro.launch import steps as steps_lib
from repro.launch.inputs import activation_spec
from repro.models import lm
from repro.parallel.sharding import ParallelConfig, split_tree, tree_shardings

cuts = json.loads(sys.argv[1])
data = np.load(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(leaf)

for arch, cut in cuts.items():
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cut.items()}
    cfg = dataclasses.replace(cfglib.get_smoke_config(arch),
                              dtype="float32", **kw)
    params, specs = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
    batch = {k[len(arch) + 3:]: jnp.asarray(data[k]) for k in data.files
             if k.startswith(arch + "/b/")}
    pcfg = ParallelConfig(mode="hybrid", blk=8)
    seq = batch["labels"].shape[1]
    shape3 = (%(b)d, seq, cfg.d_model)
    with mesh:
        pp = jax.tree.map(jax.device_put, params,
                          tree_shardings(params, specs, pcfg, mesh))
        lf = steps_lib.make_loss_fn(cfg, pcfg, mesh, shape3)
        (total, m), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            pp, batch)
        logits = jax.jit(lambda p: lm.forward(
            p, batch, cfg, pcfg, mesh, mode="train",
            x_spec=activation_spec(shape3, pcfg, mesh))[0])(pp)
    out[arch + "/total"] = np.asarray(total)
    out[arch + "/logits"] = np.asarray(logits)
    for k in ("loss", "aux_loss", "z_loss"):
        out[arch + "/" + k] = np.asarray(m[k])
    flat(g, arch + "/g/")
np.savez(sys.argv[3], **out)
print("RESULT ok")
""" % dict(b=B)


def _decode(cfg, tree, pcfg, mesh, prompts, steps_n):
    """A dense prefill and ``steps_n`` greedy decodes, on ``mesh`` (or
    without one): the logits of every step and the final cache."""
    from repro_torch.convert import shard_params
    from repro_torch.launch import steps
    from repro_torch.models import lm

    p = tree if mesh is None else shard_params(
        tree, lm.param_specs(cfg, pcfg), pcfg, mesh, device="cpu")
    b, s = prompts.shape
    pre = steps.make_prefill_step(cfg, pcfg, mesh=mesh,
                                  batch_shape3=(b, s, cfg.d_model))
    dec = steps.make_serve_step(cfg, pcfg, mesh=mesh,
                                batch_shape3=(b, 1, cfg.d_model))
    cache = lm.init_cache(cfg, b, s + steps_n, "cpu", pcfg=pcfg, mesh=mesh)
    outs = []
    with torch.no_grad():
        logits, cache = pre(p, {"tokens": prompts}, cache)
        outs.append(logits)
        for _ in range(steps_n):
            tok = torch.argmax(logits[:, -1], -1)[:, None].int()
            logits, cache = dec(p, {"tokens": tok}, cache)
            outs.append(logits)
    return torch.cat(outs, 1).numpy(), cache


def port_rank(rank, archs, cuts, tmp):
    """One rank: for each architecture the loss, aux, z, logits and
    gathered gradient of ``make_loss_fn`` on the mesh, and where the
    dense engine serves it the mesh and mesh-less dense steps and the
    decode cache's recurrent states."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (
        ParallelConfig,
        as_axes,
        unshard_tree,
    )

    data = dict(np.load(os.path.join(tmp, "in.npz")))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in archs:
        cfg = cfg_of(arch, cuts)
        tree = params_from_jax(_nest(_sub(data, arch + "/p/")), cfg,
                               device="cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in _sub(data, arch + "/b/").items()}
        pcfg = ParallelConfig(mode="hybrid", blk=8)
        shape3 = (B, batch["labels"].shape[1], cfg.d_model)
        x_spec = activation_spec(shape3, pcfg, mesh)
        lb = batch_block(batch, x_spec, mesh)
        specs = lm.param_specs(cfg, pcfg)
        p = shard_params(tree, specs, pcfg, mesh, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        total, m = steps.make_loss_fn(cfg, pcfg, mesh=mesh,
                                      batch_shape3=shape3)(p, lb)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, grads)])
        gfull = unshard_tree(tree_map(lambda _: next(it), p), specs,
                             lm.param_shapes(cfg), pcfg, mesh)
        with torch.no_grad():
            logits, _, _, _ = lm.forward(p, lb, cfg, pcfg, mode="train",
                                         mesh=mesh, x_spec=x_spec)
        logits = mesh.all_gather(logits, x_spec[0], 0)
        r = {"total": float(total), "loss": float(m["loss"]),
             "aux_loss": float(m["aux_loss"]), "z_loss": float(m["z_loss"]),
             "logits": logits.numpy(),
             "grads": [t.numpy() for t in tree_leaves(gfull)]}
        if arch in DECODE:
            prompts = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, size=(4, 8)).astype(np.int32))
            got, cache = _decode(cfg, tree, pcfg, mesh, prompts, 3)
            want, full = _decode(cfg, tree, pcfg, None, prompts, 3)
            r["decode"] = (got, want)
            # every recurrent state leaf: gathered over "model" (as the
            # blocks are placed), against the mesh-less cache's rows
            specs_c = lm.cache_specs(cfg, pcfg, mesh, 4, 8 + 3)
            rows = mesh.index(specs_c["len"][0])
            same, exact = True, True
            for i in lm.recurrent_layers(cfg):
                for k, t in cache["layers"][i].items():
                    sp = specs_c["layers"][i][k]
                    dim = next((d for d, e in enumerate(sp)
                                if "model" in as_axes(e)), None)
                    if dim is None:
                        every = mesh.all_gather(t[None], "model", 0)
                        same &= all(torch.equal(every[0], e) for e in every)
                        blk = t
                    else:
                        blk = mesh.all_gather(t, "model", dim)
                    n = blk.shape[0]
                    ref = full["layers"][i][k][rows * n:(rows + 1) * n]
                    exact &= float((blk - ref).abs().max()) <= \
                        LOSS_TOL * max(float(ref.abs().max()), 1.0)
            r["state_replicated_bitwise"] = bool(same)
            r["state_matches_meshless"] = bool(exact)
        out[arch] = r
    return out if rank == 0 else None


def run_module(tmp, archs, cuts):
    """The module's fixture: JAX's init and batches to npz, the JAX
    subprocess and the 4 gloo ranks side by side."""
    import dataclasses

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    arrays = {}
    for arch in archs:
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cuts[arch].items()}
        jcfg = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                   dtype="float32", **kw)
        params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            arrays[f"{arch}/p/{key}"] = np.asarray(leaf)
        arrays.update({f"{arch}/b/{k}": v
                       for k, v in batch_of(cfg_of(arch, cuts)).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT,
         json.dumps({a: cuts[a] for a in archs}), str(tmp / "in.npz"),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(port_rank, 4, archs, cuts, str(tmp),
                            timeout=300)[0]
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


def check_loss_logits(results, arch):
    jax_out, port = results
    r = port[arch]
    _close(r["loss"], jax_out[arch + "/loss"], LOSS_TOL, "loss")
    _close(r["total"], jax_out[arch + "/total"], LOSS_TOL, "total")
    _close(r["logits"], jax_out[arch + "/logits"], LOSS_TOL, "logits")
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(r[k], float(jax_out[f"{arch}/{k}"]),
                                   rtol=AUX_RTOL, atol=1e-12)


def check_grads(results, arch, cuts):
    from repro_torch.common import tree_leaves
    from repro_torch.convert import params_from_jax

    jax_out, port = results
    want = [t.numpy() for t in tree_leaves(params_from_jax(
        _nest(_sub(jax_out, arch + "/g/")), cfg_of(arch, cuts),
        device="cpu"))]
    got = port[arch]["grads"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        _close(a, b, GRAD_TOL, f"grad leaf {i}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(tmp_path_factory.mktemp("mesh_rec"), list(CUTS), CUTS)


@pytest.mark.parametrize("arch", list(CUTS))
def test_recurrent_mesh_loss_logits_match_jax(results, arch):
    check_loss_logits(results, arch)


@pytest.mark.parametrize("arch", list(CUTS))
def test_recurrent_mesh_grads_match_jax(results, arch):
    check_grads(results, arch, CUTS)


@pytest.mark.parametrize("arch", DECODE)
def test_recurrent_mesh_dense_decode_equals_meshless(results, arch):
    _, port = results
    got, want = port[arch]["decode"]
    _close(got, want, LOSS_TOL, "decode logits")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", DECODE)
def test_recurrent_mesh_state_replicated_bitwise(results, arch):
    _, port = results
    assert port[arch]["state_replicated_bitwise"]
    assert port[arch]["state_matches_meshless"]
