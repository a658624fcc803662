"""PyTorch port vs the JAX package: Swin-MoE's baselines on a mesh.

``swin_moe_small.SMOKE_CONFIG`` (f32, global batch 8) through
``moe_impl="tutel"`` and ``"megablocks"`` on a ("pod", "data", "model")
mesh of (2, 2, 2): the port on 8 gloo ranks, JAX on 8 fake CPU devices
in one subprocess, where GSPMD computes each baseline as one global
function. The weights and images are ``test_torch_mesh_swin.py``'s.

Cases: tutel at capacity factor 0.5 (copies drop) in hybrid and in
data_centric placement, and megablocks in hybrid. Each is held to JAX's
mesh run: the logits within 1e-5 x max|ref|, aux and z within 1e-6
relative (the aux loss is ``E * sum(f_e * P_e)`` of the global means, so
the port sums the numerators over ("pod", "data") before the product),
the gradient of ce + 0.01 aux within 1e-4 x each leaf's max|grad|. The
copies each MoE block drops, summed over the batch, equal as integers
those of JAX's eager run of the same global function (its
``dispatch_combine_moe`` wrapped to count them); tutel at 0.5 drops some,
megablocks none.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.launch.mesh import launch_local
from repro_torch.models import swin as tswin
from test_torch_mesh_swin import B, CFG, _data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL, AUX_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
# (name, moe_impl, mode, capacity_factor)
CASES = [("tutel-hybrid", "tutel", "hybrid", 0.5),
         ("tutel-data", "tutel", "data_centric", 0.5),
         ("megablocks-hybrid", "megablocks", "hybrid", 1.25)]
IDS = [c[0] for c in CASES]

JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.common import cdiv
from repro.configs import swin_moe_small as jss
from repro.core import baselines
from repro.launch.mesh import make_mesh
from repro.models import swin as jswin
from repro.parallel.sharding import ParallelConfig, split_tree

cases = json.loads(sys.argv[1])
data = np.load(sys.argv[2])
cfg = jss.SMOKE_CONFIG
shapes = jax.eval_shape(lambda k: split_tree(jswin.init_swin(k, cfg))[0],
                        jax.random.PRNGKey(0))
leaves = [jnp.asarray(data["p/%d" % i])
          for i in range(len(jax.tree.leaves(shapes)))]
params = jax.tree.unflatten(jax.tree.structure(shapes), leaves)
images, labels = jnp.asarray(data["images"]), jnp.asarray(data["labels"])
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
real = baselines.dispatch_combine_moe
out = {}
for name, impl, mode, cf in cases:
    pcfg = ParallelConfig(mode=mode, blk=8, capacity_factor=cf)

    def loss(params):
        logits, aux, z = jswin.swin_forward(params, images, cfg, pcfg, mesh,
                                            moe_impl=impl)
        onehot = jax.nn.one_hot(labels, cfg.num_classes)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return ce + 0.01 * aux, (logits, aux, z)

    with mesh:
        (total, (logits, aux, z)), g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    out.update({name + "/logits": logits, name + "/aux": aux,
                name + "/z": z})
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[name + "/g/%d" % i] = leaf
    drops = []

    def counting(x, r, w1, *a, capacity=None, capacity_factor=1.25, **kw):
        n, k = r.expert_idx.shape
        e = w1.shape[0]
        cap = capacity or max(int(cdiv(n * k, e) * capacity_factor), 1)
        rank, _ = baselines._dispatch_ranks(r.expert_idx, e)
        drops.append(int(jnp.sum(rank >= cap)))
        return real(x, r, w1, *a, capacity=cap, **kw)

    baselines.dispatch_combine_moe = counting
    try:
        jswin.swin_forward(params, images, cfg, pcfg, None, moe_impl=impl)
    finally:
        baselines.dispatch_combine_moe = real
    out[name + "/drops"] = np.asarray(drops)
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
print("RESULT ok")
"""


def _port_rank(rank, cases):
    """One rank: each case's logits, aux, z, gathered gradient and the
    copies each MoE block dropped over the whole batch."""
    from repro_torch.convert import shard_params
    from repro_torch.core import baselines
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import ParallelConfig, unshard_tree

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    params, images, labels = _data()
    g = mesh.index(("pod", "data"))
    n = B // mesh.size(("pod", "data"))
    img = torch.from_numpy(images[g * n:(g + 1) * n])
    lab = torch.from_numpy(labels[g * n:(g + 1) * n])
    shapes = tswin.param_shapes(CFG)
    real = baselines.dispatch_combine_moe
    out = {}
    for name, impl, mode, cf in cases:
        drops = []

        def counting(x, r, w1, *a, capacity=None, capacity_factor=1.25,
                     rank_offset=None, **kw):
            nn, k = r.expert_idx.shape
            e = w1.shape[0]
            cap = capacity or baselines.tutel_capacity(nn, k, e,
                                                       capacity_factor)
            rk, _ = baselines._dispatch_ranks(r.expert_idx, e)
            if rank_offset is not None:
                rk = rk + rank_offset[r.expert_idx.long()]
            drops.append(int((rk >= cap).sum()))
            return real(x, r, w1, *a, capacity=cap, rank_offset=rank_offset,
                        **kw)

        pcfg = ParallelConfig(blk=8, mode=mode, capacity_factor=cf)
        specs = tswin.param_specs(CFG, pcfg)
        p = shard_params(params, specs, pcfg, mesh, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        baselines.dispatch_combine_moe = counting
        try:
            logits, aux, z = tswin.swin_forward(p, img, CFG, pcfg, mesh,
                                                moe_impl=impl)
            del drops[:]
            total, _ = tswin.make_loss_fn(CFG, pcfg, moe_impl=impl,
                                          mesh=mesh)(p, img, lab)
        finally:
            baselines.dispatch_combine_moe = real
        grads = torch.autograd.grad(total, leaves)
        it = iter(grads)
        gtree = tree_map(lambda _: next(it), p)
        tswin._sync_dense_grads(gtree, mesh)
        gfull = unshard_tree(gtree, specs, shapes, pcfg, mesh)
        dropped = mesh.all_reduce(torch.tensor(drops), ("pod", "data"))
        if rank == 0:
            out[name] = {
                "logits": mesh.all_gather(logits.detach(), ("pod", "data"),
                                          0).numpy(),
                "aux": float(aux), "z": float(z),
                "grads": [t.numpy() for t in tree_leaves(gfull)],
                "drops": dropped.numpy()}
        else:
            mesh.all_gather(logits.detach(), ("pod", "data"), 0)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_baselines")
    params, images, labels = _data()
    np.savez(tmp / "in.npz", images=images, labels=labels,
             **{f"p/{i}": a for i, a in enumerate(tree_leaves(params))})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(CASES),
         str(tmp / "in.npz"), str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 8, CASES, timeout=240)[0]
        _, err = proc.communicate(timeout=300)
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
def test_mesh_baseline_forward_matches_jax(results, case):
    jax_out, port = results
    r, name = port[case[0]], case[0]
    _close(r["logits"], jax_out[name + "/logits"], LOGIT_TOL, "logits")
    for k in ("aux", "z"):
        np.testing.assert_allclose(r[k], float(jax_out[f"{name}/{k}"]),
                                   rtol=AUX_RTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_baseline_grads_match_jax(results, case):
    jax_out, port = results
    got = port[case[0]]["grads"]
    assert len(got) == len([k for k in jax_out
                            if k.startswith(case[0] + "/g/")])
    for i, a in enumerate(got):
        _close(a, jax_out[f"{case[0]}/g/{i}"], GRAD_TOL, f"grad leaf {i}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_baseline_drops_equal_jax(results, case):
    jax_out, port = results
    got = port[case[0]]["drops"]
    want = jax_out[case[0] + "/drops"]
    np.testing.assert_array_equal(got, want)
    if case[1] == "tutel":
        assert want.sum() > 0, want
    else:
        assert want.sum() == 0, want
