"""PyTorch port vs the JAX package: Swin-MoE on a mesh.

``swin_moe_small.SMOKE_CONFIG`` (f32, global batch 8) on a ("pod", "data",
"model") mesh of (2, 2, 2): the port on 8 gloo ranks on the CPU
(``launch.mesh.launch_local``), the JAX package on 8 fake CPU devices in
one subprocess for the module. Same numpy weights (the port's init,
nudged by seeded noise) and images; each rank holds the rows of its
("pod", "data") group and its parameter shards (``convert.shard_params``
under ``swin.param_specs``).

* hybrid, against JAX's hybrid mesh run: logits within 1e-5 x max|ref|,
  aux and z within 1e-6 relative, and the gradient of ce + 0.01 aux
  (gathered back to global leaves) within 1e-4 x max|grad| of each leaf;
* model_centric, data_centric (``shared_cache`` and ``janus``), auto and
  ep (capacity 8, nothing dropped), against JAX's mesh-less forward for
  the logits (same limit); their aux, z and gradients against JAX's
  hybrid mesh run, since on a mesh both packages average each device's
  aux over its own rows, which the mesh-less aux is not;
* one AdamW step of ``make_train_step`` on the mesh: its gathered
  parameters equal (within 1e-6) the port's mesh-less ``apply_updates``
  applied to the gathered mesh gradient, and its loss JAX's; its clip
  norm, which each rank sums from its own shards, is the norm of the
  gathered gradient within 1e-5 relative and of JAX's mesh gradient
  within 1e-4 relative (the gradients' own limit). Adam's first update
  does not change when the gradient is scaled, so the step alone cannot
  see a norm that counts a shard twice or leaves one out;
* both packages refuse a ("data", "model") mesh (a ``ValueError`` in the
  port; ``shard_map`` in JAX, as Swin's tokens are placed over "pod").
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs import swin_moe_small as tss
from repro_torch.launch.mesh import launch_local
from repro_torch.models import swin as tswin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tss.SMOKE_CONFIG
B = 8
LOGIT_TOL, AUX_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-6, 1e-4, 1e-6
NORM_RTOL = 1e-5
MODES = [("hybrid", "shared_cache"), ("model_centric", "none"),
         ("data_centric", "shared_cache"), ("data_centric", "janus"),
         ("auto", "shared_cache"), ("ep", "none")]
IDS = [f"{m}-{p}" for m, p in MODES]
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4, master_fp32=False)


def _data():
    pt = tswin.init_swin(CFG, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    params = tree_map(lambda t: (t.numpy() + rng.normal(size=t.shape) * 0.05)
                      .astype(np.float32), pt)
    images = rng.normal(size=(B, CFG.img_size, CFG.img_size,
                              CFG.in_chans)).astype(np.float32)
    labels = rng.integers(0, CFG.num_classes, size=B).astype(np.int32)
    return params, images, labels


JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import swin_moe_small as jss
from repro.launch.mesh import make_mesh
from repro.models import swin as jswin
from repro.parallel.sharding import ParallelConfig, split_tree

data = np.load(sys.argv[1])
cfg = jss.SMOKE_CONFIG
shapes = jax.eval_shape(lambda k: split_tree(jswin.init_swin(k, cfg))[0],
                        jax.random.PRNGKey(0))
leaves = [jnp.asarray(data["p/%d" % i])
          for i in range(len(jax.tree.leaves(shapes)))]
params = jax.tree.unflatten(jax.tree.structure(shapes), leaves)
images, labels = jnp.asarray(data["images"]), jnp.asarray(data["labels"])
pcfg = ParallelConfig(mode="hybrid", blk=8)

def loss(params, mesh):
    logits, aux, z = jswin.swin_forward(params, images, cfg, pcfg, mesh)
    onehot = jax.nn.one_hot(labels, cfg.num_classes)
    ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
    return ce + 0.01 * aux, (logits, aux, z)

out = {}
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
with mesh:
    (total, (logits, aux, z)), g = jax.jit(jax.value_and_grad(
        lambda p: loss(p, mesh), has_aux=True))(params)
out.update(total=total, logits=logits, aux=aux, z=z)
for i, leaf in enumerate(jax.tree.leaves(g)):
    out["g/%d" % i] = leaf
flat, _, _ = jax.jit(lambda p: jswin.swin_forward(
    p, images, cfg, pcfg, None))(params)
out["logits_nomesh"] = flat
mesh2 = make_mesh((4, 2), ("data", "model"))
try:
    with mesh2:
        jax.jit(lambda p: loss(p, mesh2))(params)
    out["two_axis_error"] = np.array("")
except Exception as e:                       # noqa: BLE001
    out["two_axis_error"] = np.array(type(e).__name__ + ": " + str(e)[:200])
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("RESULT ok")
"""


def _port_rank(rank, modes):
    """One rank: for each (mode, cache policy) the forward, the gathered
    gradient and one train step; then the 2-axis refusal."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import ParallelConfig, unshard_tree

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    params, images, labels = _data()
    g = mesh.index(("pod", "data"))
    n = B // mesh.size(("pod", "data"))
    img = torch.from_numpy(images[g * n:(g + 1) * n])
    lab = torch.from_numpy(labels[g * n:(g + 1) * n])
    shapes = tswin.param_shapes(CFG)
    opt_cfg = adamw.OptimizerConfig(**OPT)
    out = {}
    for mode, policy in modes:
        pcfg = ParallelConfig(blk=8, mode=mode, cache_policy=policy,
                              capacity_factor=8.0)
        specs = tswin.param_specs(CFG, pcfg)
        p = shard_params(params, specs, pcfg, mesh, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        loss_fn = tswin.make_loss_fn(CFG, pcfg, mesh=mesh)
        logits, aux, z = tswin.swin_forward(p, img, CFG, pcfg, mesh)
        total, metrics = loss_fn(p, img, lab)
        grads = torch.autograd.grad(total, leaves)
        it = iter(grads)
        gtree = tree_map(lambda _: next(it), p)
        tswin._sync_dense_grads(gtree, mesh)
        gfull = unshard_tree(gtree, specs, shapes, pcfg, mesh)
        logits_all = mesh.all_gather(logits.detach(), ("pod", "data"), 0)
        # one train step on fresh shards
        p = shard_params(params, specs, pcfg, mesh, device="cpu")
        opt = adamw.init_opt_state(p, opt_cfg)
        step = tswin.make_train_step(CFG, pcfg, opt_cfg, mesh=mesh)
        p, opt, m = step(p, opt, img, lab)
        pfull = unshard_tree(tree_map(lambda t: t.detach(), p), specs,
                             shapes, pcfg, mesh)
        if rank == 0:
            out[(mode, policy)] = {
                "logits": logits_all.numpy(), "aux": float(aux),
                "z": float(z), "loss": float(metrics["ce"]
                                             + 0.01 * metrics["aux_loss"]),
                "grads": [t.numpy() for t in tree_leaves(gfull)],
                "step_loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "step_params": [t.numpy() for t in tree_leaves(pfull)]}
    mesh2 = make_mesh((4, 2), ("data", "model"))
    try:
        tswin.swin_forward(shard_params(params, tswin.param_specs(
            CFG, ParallelConfig()), ParallelConfig(), mesh2, device="cpu"),
            img, CFG, ParallelConfig(blk=8), mesh2)
        out["two_axis_error"] = ""
    except ValueError as e:
        out["two_axis_error"] = str(e)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_swin")
    params, images, labels = _data()
    np.savez(tmp / "in.npz", images=images, labels=labels,
             **{f"p/{i}": a for i, a in enumerate(tree_leaves(params))})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 8, MODES, timeout=240)[0]
        _, stderr = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "jax.npz")), port


def _close(got, want, tol_rel, what):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol_rel * scale, (what, err, scale)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_swin_mesh_forward_and_grads_match_jax(results, mode):
    jax_out, port = results
    r = port[mode]
    ref_logits = (jax_out["logits"] if mode[0] == "hybrid"
                  else jax_out["logits_nomesh"])
    _close(r["logits"], ref_logits, LOGIT_TOL, "logits")
    np.testing.assert_allclose(r["aux"], float(jax_out["aux"]),
                               rtol=AUX_RTOL)
    np.testing.assert_allclose(r["z"], float(jax_out["z"]), rtol=AUX_RTOL)
    np.testing.assert_allclose(r["loss"], float(jax_out["total"]),
                               rtol=AUX_RTOL)
    n = len(r["grads"])
    assert n == len([k for k in jax_out if k.startswith("g/")])
    for i, got in enumerate(r["grads"]):
        _close(got, jax_out[f"g/{i}"], GRAD_TOL, f"grad leaf {i}")


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_swin_mesh_train_step_is_the_meshless_update(results, mode):
    """The sharded AdamW (moments on the shards, the global clip norm)
    against ``apply_updates`` on the whole tree with the same gradient."""
    from repro_torch.optim import adamw

    jax_out, port = results
    r = port[mode]
    params, _, _ = _data()
    p = tree_map(torch.from_numpy, params)
    it = iter(r["grads"])
    grads = tree_map(lambda _: torch.from_numpy(next(it)), p)
    opt_cfg = adamw.OptimizerConfig(**OPT)
    p, _, _ = adamw.apply_updates(p, grads, adamw.init_opt_state(p, opt_cfg),
                                  opt_cfg)
    for i, (got, want) in enumerate(zip(r["step_params"], tree_leaves(p))):
        err = float(np.abs(got - want.numpy()).max())
        assert err <= STEP_TOL, (i, err)
    np.testing.assert_allclose(r["step_loss"], float(jax_out["total"]),
                               rtol=AUX_RTOL)


def _global_norm(leaves):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(a, np.float64)))
                             for a in leaves)))


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_swin_mesh_clip_norm_is_the_global_norm(results, mode):
    """``_mesh_grad_norm`` sums each MoE leaf's squares over the axes it is
    sharded on and counts the replicated dense leaves once: the step's
    ``grad_norm`` is the whole gradient tree's."""
    jax_out, port = results
    r = port[mode]
    np.testing.assert_allclose(r["grad_norm"], _global_norm(r["grads"]),
                               rtol=NORM_RTOL)
    n = len([k for k in jax_out if k.startswith("g/")])
    np.testing.assert_allclose(
        r["grad_norm"], _global_norm(jax_out[f"g/{i}"] for i in range(n)),
        rtol=GRAD_TOL)


def test_two_axis_mesh_is_refused_by_both(results):
    jax_out, port = results
    assert "pod" in str(jax_out["two_axis_error"])
    assert "pod" in port["two_axis_error"]
