"""PyTorch port vs the JAX package: router telemetry on a mesh.

The port runs on 4 gloo ranks (``launch.mesh.launch_local``, a ("data",
"model") mesh of (2, 2)); JAX on a mesh of the same shape over 4 fake CPU
devices in one subprocess for the module. With ``collect_router_stats``
set, each rank's stats must be the global ones, the same on every rank,
and equal JAX's: the integer counts bitwise, the entropy sum within
``ENT_RTOL`` relative.

* ``moe_layer`` with tokens sharded over "model" and replicated over it,
  in hybrid, model-centric, data-centric and auto forced to data-centric
  dispatch (where each rank routes its own rows and nothing is divided),
  MLP experts, a skewed Eq. 1 plan (masked rows count nothing), and the
  "ep" mode at capacity factor 0.5 (drops counted); the hybrid case's
  counts also equal the mesh-less layer's on the whole batch, and a
  batch whole on every rank is counted once (where JAX counts it once a
  data rank);
* ``lm.forward``'s fifth element on qwen3-moe-30b-a3b's 2-layer smoke
  config (f32, 8 x 16 tokens), in hybrid, data_centric and ep, and the
  dense decode step's third element (8 slots) on the mesh.
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
ENT_RTOL = 1e-5
KEYS = ("expert_tokens", "dropped_tokens", "entropy_sum", "tokens")
TOK_TP, TOK_REP = ["data", "model", None], ["data", None, None]
SKEW_BATCH = 6        # make_hetero_plan((1, 2), global_batch=6): (4, 2)
QWEN = "qwen3-moe-30b-a3b"
LM_B, LM_S, MAX_SEQ = 8, 16, 24

# (name, glu, mode, forced layer mode, x_spec, capacity factor, plan)
MOE_CASES = [
    ("hybrid-tp", True, "hybrid", None, TOK_TP, 8.0, None),
    ("model-rep", True, "model_centric", None, TOK_REP, 8.0, None),
    ("data-tp", True, "data_centric", None, TOK_TP, 8.0, None),
    ("auto_dc-tp", True, "auto", "data_centric", TOK_TP, 8.0, None),
    ("mlp-hybrid-tp", False, "hybrid", None, TOK_TP, 8.0, None),
    ("hybrid-skew", True, "hybrid", None, TOK_TP, 8.0, (1.0, 2.0)),
    ("ep-drops", True, "ep", None, TOK_TP, 0.5, None),
]
LM_MODES = ["hybrid", "data_centric", "ep"]


def _moe_inputs(glu):
    rng = np.random.default_rng(17 if glu else 18)
    f32 = np.float32
    p = {"router": (rng.normal(size=(D, E)) * 0.5).astype(f32)}
    shapes = ((("w_gate", (E, D, F)), ("w_up", (E, D, F)),
               ("w_down", (E, F, D))) if glu else
              (("w1", (E, D, F)), ("b1", (E, F)), ("w2", (E, F, D)),
               ("b2", (E, D))))
    for name, shape in shapes:
        p[name] = (rng.normal(size=shape) * 0.1).astype(f32)
    return rng.normal(size=(B, S, D)).astype(f32), p


def _lm_tokens(vocab):
    rng = np.random.default_rng(2)
    return (rng.integers(0, vocab, size=(LM_B, LM_S)).astype(np.int32),
            rng.integers(0, vocab, size=(LM_B, 1)).astype(np.int32))


JAX_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs as cfglib
from repro.core.hetero import make_hetero_plan
from repro.launch import steps as steps_lib
from repro.launch.inputs import activation_spec
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel.moe_parallel import MoEParams, MoEStatic, moe_layer
from repro.parallel.sharding import ParallelConfig, split_tree

moe_cases, lm_modes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
data = np.load(sys.argv[3])
B, S, E, K = %(b)d, %(s)d, %(e)d, %(k)d
mesh = make_mesh((2, 2), ("data", "model"))
out = {}

def keep(prefix, st):
    for k, v in st.items():
        out[prefix + "/" + k] = np.asarray(v)

for name, glu, mode, forced, spec, cf, lat in moe_cases:
    pre = "glu/" if glu else "mlp/"
    keys = [k[4:] for k in data.files if k.startswith(pre) and k[4:] != "x"]
    p = MoEParams(**{k: jnp.asarray(data[pre + k]) for k in keys})
    plan = None if lat is None else make_hetero_plan(lat,
                                                     global_batch=%(skew)d)
    cfg = ParallelConfig(mode=mode, blk=16, capacity_factor=cf,
                         forced_layer_mode=forced, hetero_plan=plan,
                         collect_router_stats=True)
    ms = MoEStatic(num_experts=E, top_k=K, act="silu", glu=glu)
    xs = P(*spec)
    with mesh:
        _, _, _, st = jax.jit(lambda x, p: moe_layer(
            x, p, ms, cfg, mesh, x_spec=xs))(jnp.asarray(data[pre + "x"]), p)
    keep("moe/" + name, st)

cfg = dataclasses.replace(cfglib.get_smoke_config("%(qwen)s"), num_layers=2,
                          dtype="float32")
params, _ = split_tree(lm.init_params(jax.random.PRNGKey(0), cfg))
toks, dec = jnp.asarray(data["lm/tokens"]), jnp.asarray(data["lm/decode"])
for mode in lm_modes:
    pcfg = ParallelConfig(mode=mode, blk=8, capacity_factor=8.0,
                          collect_router_stats=True)
    shape3 = (B, S, cfg.d_model)
    with mesh:
        o = jax.jit(lambda p: lm.forward(
            p, {"tokens": toks}, cfg, pcfg, mesh, mode="train",
            x_spec=activation_spec(shape3, pcfg, mesh)))(params)
        assert len(o) == 5
        keep("lm/" + mode, o[4])
        step = jax.jit(steps_lib.make_serve_step(cfg, pcfg, mesh,
                                                 (B, 1, cfg.d_model)))
        o = step(params, {"tokens": dec}, lm.init_cache(cfg, B, %(max_seq)d))
        assert len(o) == 3
        keep("decode/" + mode, o[2])
np.savez(sys.argv[4], **out)
print("RESULT ok")
""" % dict(b=B, s=S, e=E, k=K, skew=SKEW_BATCH, qwen=QWEN, max_seq=MAX_SEQ)


def _plain(st):
    return {k: v.numpy() for k, v in st.items()}


def _port_rank(rank, moe_cases, lm_modes, tmp):
    import dataclasses

    from repro_torch import configs as cfglib
    from repro_torch.convert import params_from_jax, shard_params
    from repro_torch.core.hetero import make_hetero_plan
    from repro_torch.launch import steps
    from repro_torch.launch.inputs import activation_spec, batch_block
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import moe_parallel as mp
    from repro_torch.parallel.sharding import ParallelConfig, shard

    data = dict(np.load(os.path.join(tmp, "in.npz")))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, glu, mode, forced, spec, cf, lat in moe_cases:
        pre = "glu/" if glu else "mlp/"
        x = data[pre + "x"]
        p = {k[4:]: v for k, v in data.items()
             if k.startswith(pre) and k[4:] != "x"}
        plan = None if lat is None else make_hetero_plan(
            lat, global_batch=SKEW_BATCH)
        cfg = ParallelConfig(mode=mode, blk=16, capacity_factor=cf,
                             forced_layer_mode=forced, hetero_plan=plan,
                             collect_router_stats=True)
        table = mp.EP_PARAM_LOGICAL if mode == "ep" else mp.MOE_PARAM_LOGICAL
        spec = tuple(spec)
        xl = shard(torch.from_numpy(x), spec, ParallelConfig(), mesh)
        pl = {k: shard(torch.from_numpy(v), table[k], cfg, mesh)
              for k, v in p.items()}
        ms = mp.MoEStatic(E, K, act="silu", glu=glu, d_ff=F)
        res = mp.moe_layer(xl, pl, ms, cfg, mesh, x_spec=spec)
        assert len(res) == 4
        out["moe/" + name] = _plain(res[3])
        if name == "hybrid-tp":
            # the global counts are the mesh-less layer's on the whole batch
            whole = mp.moe_layer(torch.from_numpy(x),
                                 {k: torch.from_numpy(v)
                                  for k, v in p.items()}, ms,
                                 ParallelConfig(blk=16,
                                                collect_router_stats=True))
            out["meshless/" + name] = _plain(whole[3])
            # one sequence whole on every rank (a batch-1 serving forward):
            # each row counted once, as without a mesh
            one = torch.from_numpy(x[:1])
            rep = mp.moe_layer(one, pl, ms, cfg, mesh,
                               x_spec=(None, None, None))
            out["replicated/" + name] = _plain(rep[3])
            out["replicated_meshless/" + name] = _plain(mp.moe_layer(
                one, {k: torch.from_numpy(v) for k, v in p.items()}, ms,
                ParallelConfig(blk=16, collect_router_stats=True))[3])

    cfg = dataclasses.replace(cfglib.get_smoke_config(QWEN), num_layers=2,
                              dtype="float32")
    tree = params_from_jax(_nest({k[5:]: v for k, v in data.items()
                                  if k.startswith("lm/p/")}), cfg,
                           device="cpu")
    toks = torch.from_numpy(data["lm/tokens"])
    dec = torch.from_numpy(data["lm/decode"])
    for mode in lm_modes:
        pcfg = ParallelConfig(mode=mode, blk=8, capacity_factor=8.0,
                              collect_router_stats=True)
        p = shard_params(tree, lm.param_specs(cfg, pcfg), pcfg, mesh,
                         device="cpu")
        x_spec = activation_spec((LM_B, LM_S, cfg.d_model), pcfg, mesh)
        with torch.no_grad():
            o = lm.forward(p, batch_block({"tokens": toks}, x_spec, mesh),
                           cfg, pcfg, mode="train", mesh=mesh, x_spec=x_spec)
            assert len(o) == 5
            out["lm/" + mode] = _plain(o[4])
            step = steps.make_serve_step(cfg, pcfg, mesh=mesh,
                                         batch_shape3=(LM_B, 1, cfg.d_model))
            o = step(p, {"tokens": dec},
                     lm.init_cache(cfg, LM_B, MAX_SEQ, "cpu", pcfg=pcfg,
                                   mesh=mesh))
            assert len(o) == 3
            out["decode/" + mode] = _plain(o[2])
    return out


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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.parallel.sharding import split_tree

    tmp = tmp_path_factory.mktemp("mesh_obs")
    arrays = {}
    for glu in (True, False):
        x, p = _moe_inputs(glu)
        pre = "glu/" if glu else "mlp/"
        arrays.update({pre + "x": x, **{pre + k: v for k, v in p.items()}})
    cfg = dataclasses.replace(jcfglib.get_smoke_config(QWEN), num_layers=2,
                              dtype="float32")
    params, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arrays["lm/p/" + key] = np.asarray(leaf)
    arrays["lm/tokens"], arrays["lm/decode"] = _lm_tokens(cfg.vocab_size)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(MOE_CASES),
         json.dumps(LM_MODES), str(tmp / "in.npz"), str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = launch_local(_port_rank, 4, MOE_CASES, LM_MODES, str(tmp),
                            timeout=240)
        _, stderr = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "jax.npz")), port


def _check(got: dict, jax_out: dict, prefix: str):
    for k in KEYS:
        want = jax_out[f"{prefix}/{k}"]
        if k == "entropy_sum":
            np.testing.assert_allclose(got[k], want, rtol=ENT_RTOL,
                                       err_msg=prefix)
        else:
            assert got[k].dtype == want.dtype == np.int32, (prefix, k)
            np.testing.assert_array_equal(got[k], want, err_msg=prefix)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_layer_stats_on_mesh_match_jax(results, case):
    jax_out, port = results
    name = "moe/" + case[0]
    for rank_out in port:                 # global: the same on every rank
        _check(rank_out[name], jax_out, name)
    st = port[0][name]
    assert int(st["expert_tokens"].sum()) == K * int(st["tokens"])
    if case[0] == "ep-drops":
        assert int(st["dropped_tokens"]) > 0
    elif case[0] == "hybrid-skew":
        assert int(st["tokens"]) == SKEW_BATCH * S     # the masked rows out
    else:
        assert int(st["tokens"]) == B * S


def test_mesh_stats_equal_the_meshless_layer(results):
    _, port = results
    whole, mesh = port[0]["meshless/hybrid-tp"], port[0]["moe/hybrid-tp"]
    for k in ("expert_tokens", "dropped_tokens", "tokens"):
        np.testing.assert_array_equal(mesh[k], whole[k])
    np.testing.assert_allclose(mesh["entropy_sum"], whole["entropy_sum"],
                               rtol=ENT_RTOL)


def test_replicated_batch_counts_each_row_once(results):
    """A batch whole on every rank (x_spec (None, None, None), as the
    paged engine's batch-1 prefill and score forwards run on a mesh) is
    counted once: the port divides by every rank that routed the rows.
    JAX's ``moe_layer`` divides by the TP size only and counts such a
    batch once a data rank (twice here; ROADMAP.md C.5)."""
    _, port = results
    for rank_out in port:
        got = rank_out["replicated/hybrid-tp"]
        want = rank_out["replicated_meshless/hybrid-tp"]
        for k in ("expert_tokens", "dropped_tokens", "tokens"):
            np.testing.assert_array_equal(got[k], want[k])
        assert int(got["tokens"]) == S
        np.testing.assert_allclose(got["entropy_sum"], want["entropy_sum"],
                                   rtol=ENT_RTOL)


@pytest.mark.parametrize("mode", LM_MODES)
def test_lm_forward_and_decode_step_stats_on_mesh_match_jax(results, mode):
    jax_out, port = results
    for rank_out in port:
        _check(rank_out["lm/" + mode], jax_out, "lm/" + mode)
        _check(rank_out["decode/" + mode], jax_out, "decode/" + mode)
    assert int(port[0]["lm/" + mode]["tokens"]) == LM_B * LM_S * 2
    assert int(port[0]["decode/" + mode]["tokens"]) == LM_B * 2
