"""PyTorch port vs the JAX package: error-feedback int8 gradient
compression (``optim.compression``).

``compressed_psum`` runs on 4 gloo ranks (``launch.mesh.launch_local``,
a ("pod",) mesh of 4) and JAX's inside a ``shard_map`` over 4 fake CPU
devices in one subprocess (``tests/test_distributed.py``'s idiom), on the
same numpy gradients, for 3 error-feedback steps: each step's sum and
every rank's residual must equal JAX's bit for bit. The scale is one f32
division of an all-reduced maximum, the int8 payloads sum as int32, and
dequantising is one multiply, so nothing is left to summation order. The
sum must also stay within 2 % (relative L2) of the exact f32 sum, JAX's
own limit. ``compress_roundtrip``, the tree form and the int8 helpers of
``quant.core`` are held to JAX's on one process.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.quant import core as jq
from repro_torch.launch.mesh import launch_local
from repro_torch.optim import compression as tcomp
from repro_torch.quant import core as tq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, COLS = 4, 3, 96


def _grads():
    """(STEPS, WORLD, COLS) f32: each step's gradient on each rank, of
    different magnitudes so the agreed scale is another rank's at times."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(STEPS, WORLD, COLS)).astype(np.float32)
    return g * np.array([1.0, 3.0, 0.5, 2.0], np.float32)[None, :, None]


JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.optim.compression import compressed_psum
from repro.parallel.moe_parallel import _shard_map

g = np.load(sys.argv[1])
mesh = make_mesh((g.shape[1],), ("pod",))

def body(g_loc, r_loc):
    out, res = compressed_psum(g_loc[0], "pod", r_loc[0])
    return out[None], res[None]

step = jax.jit(_shard_map(body, mesh, in_specs=(P("pod", None),) * 2,
                          out_specs=(P("pod", None), P("pod", None))))
r = jnp.zeros(g.shape[1:], jnp.float32)
outs, ress = [], []
with mesh:
    for t in range(g.shape[0]):
        out, r = step(jnp.asarray(g[t]), r)
        outs.append(np.asarray(out))
        ress.append(np.asarray(r))
np.savez(sys.argv[2], out=np.stack(outs), res=np.stack(ress))
print("RESULT ok")
"""


def _port_rank(rank, g):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (
        compressed_psum,
        tree_compressed_psum,
    )

    mesh = make_mesh((g.shape[1],), ("pod",))
    r = None
    outs, ress = [], []
    for t in range(g.shape[0]):
        out, r = compressed_psum(torch.from_numpy(g[t, rank]), mesh, "pod", r)
        outs.append(out.numpy())
        ress.append(r.numpy())
    # the tree form: the same leaf under a dict and a list, from zeros
    tree = {"a": torch.from_numpy(g[0, rank]),
            "b": [torch.from_numpy(g[1, rank])]}
    t_out, t_res = tree_compressed_psum(tree, mesh, "pod")
    one0, r0 = compressed_psum(tree["a"], mesh, "pod")
    one1, r1 = compressed_psum(tree["b"][0], mesh, "pod")
    tree_ok = (torch.equal(t_out["a"], one0) and torch.equal(t_res["a"], r0)
               and torch.equal(t_out["b"][0], one1)
               and torch.equal(t_res["b"][0], r1))
    return np.stack(outs), np.stack(ress), tree_ok


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's npz, the port's per-rank results): one launch of each."""
    tmp = tmp_path_factory.mktemp("compression")
    g = _grads()
    np.save(tmp / "g.npy", g)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "g.npy"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, WORLD, g, timeout=120)
        _, stderr = jax_proc.communicate(timeout=180)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "jax.npz")), port


def test_compressed_psum_matches_jax_on_four_ranks(runs):
    want, port = runs
    g = _grads()
    for rank, (outs, ress, tree_ok) in enumerate(port):
        np.testing.assert_array_equal(outs, want["out"][:, rank])
        np.testing.assert_array_equal(ress, want["res"][:, rank])
        assert tree_ok
        # every rank holds the same sum
        np.testing.assert_array_equal(outs, port[0][0])
    exact = g[0].sum(0)
    rel = np.linalg.norm(port[0][0][0] - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel


def test_error_feedback_carries_the_residual(runs):
    """Over the 3 steps, each rank's residual is its ``g + r`` less what it
    sent: summing every step's output and the last residuals gives the
    exact sum of the gradients up to f32 rounding."""
    _, port = runs
    g = _grads()
    sent = port[0][0].sum(0)                           # what arrived
    left = sum(p[1][-1] for p in port)                 # still carried
    np.testing.assert_allclose(sent + left, g.sum((0, 1)), rtol=0,
                               atol=1e-4 * np.abs(g.sum((0, 1))).max())


def test_roundtrip_and_int8_helpers_match_jax():
    x = (np.random.default_rng(1).normal(size=(5, 33)) * 7).astype(np.float32)
    x[0, 0] = 0.0
    rec_j, res_j = jcomp.compress_roundtrip(jnp.asarray(x))
    rec_t, res_t = tcomp.compress_roundtrip(torch.from_numpy(x))
    np.testing.assert_array_equal(rec_t.numpy(), np.asarray(rec_j))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    scale = np.float32(0.05)
    qj = jq.quantize_int8(jnp.asarray(x), jnp.asarray(scale))
    qt = tq.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(
        tq.dequantize_int8(qt, torch.tensor(scale)).numpy(),
        np.asarray(jq.dequantize_int8(qj, jnp.asarray(scale))))
    assert int(np.abs(qt.numpy()).max()) == 127
