"""PyTorch port vs the JAX package: router telemetry without a mesh.

``obs.device`` (``expert_stats``, ``RouterStatsDrain``) and the stats as
they travel up: ``moe_layer`` (the hexa island; the "ep" island with
capacity drops), ``lm.forward``'s fifth element, the train step's
``metrics["router_stats"]`` and the dense serve and prefill steps' third
element, from the same numpy inputs and weights (``params_from_jax``) on
the f32 smoke configs. Before the port's stats, ``collect_router_stats``
without a mesh was ignored: these tests hold it to JAX's arity.

The integer stats (per-expert counts, drops, tokens) must equal JAX's
bitwise, and a host ``np.bincount`` of the routing decisions; the entropy
sum is f32 and held to ``ENT_RTOL`` relative (summation order). Outputs
beside the stats at 1e-5 x max|ref|. The drains of both packages, fed
the same stats, must render the same Prometheus text, and ``push`` must
not copy to the host.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jcfglib
from repro.core.routing import route as jroute
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.obs import device as jdev
from repro.obs.metrics import MetricsRegistry as JReg
from repro.optim import adamw as jadamw
from repro.parallel import moe_parallel as jmp
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.core.routing import route as troute
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.obs import device as tdev
from repro_torch.obs.metrics import MetricsRegistry as TReg
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import moe_parallel as tmp
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

INT_KEYS = ("expert_tokens", "dropped_tokens", "tokens")
ENT_RTOL = 1e-5
N, D, F, E, K = 24, 16, 32, 8, 2
QWEN = "qwen3-moe-30b-a3b"


def assert_stats_equal(got: dict, want: dict, rtol: float = ENT_RTOL):
    assert set(got) == set(want) == set(tdev.STAT_KEYS)
    for k in INT_KEYS:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == np.int32 and w.dtype == np.int32, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["entropy_sum"].dtype == torch.float32
    np.testing.assert_allclose(float(got["entropy_sum"]),
                               float(want["entropy_sum"]), rtol=rtol)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _routing(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(D, E)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", ["plain", "masked", "dropped"])
def test_expert_stats_match_jax_and_host_recount(case):
    x, w = _routing(0)
    rj = jroute(jnp.asarray(x), jnp.asarray(w), K)
    rt = troute(torch.from_numpy(x), torch.from_numpy(w), K)
    np.testing.assert_array_equal(rt.expert_idx.numpy(),
                                  np.asarray(rj.expert_idx))
    mask = drop = None
    if case == "masked":
        mask = np.arange(N) < N // 2 + 3
    if case == "dropped":
        drop = np.int32(5)
    sj = jdev.expert_stats(rj.expert_idx, rj.probs, E,
                           valid_mask=None if mask is None
                           else jnp.asarray(mask),
                           dropped=None if drop is None else jnp.asarray(drop))
    st = tdev.expert_stats(rt.expert_idx, rt.probs, E,
                           valid_mask=None if mask is None
                           else torch.from_numpy(mask),
                           dropped=None if drop is None
                           else torch.tensor(drop))
    assert_stats_equal(st, sj)
    rows = np.asarray(rj.expert_idx) if mask is None \
        else np.asarray(rj.expert_idx)[mask]
    np.testing.assert_array_equal(
        st["expert_tokens"].numpy(),
        np.bincount(rows.reshape(-1), minlength=E).astype(np.int32))
    assert int(st["tokens"]) == len(rows)
    assert int(st["expert_tokens"].sum()) == K * len(rows)


def test_zero_and_add_stats_allocate_fresh_tensors():
    a = tdev.zero_stats(E)
    b = tdev.expert_stats(torch.zeros(3, K, dtype=torch.long),
                          torch.full((3, E), 1.0 / E), E)
    s = tdev.add_stats(a, b)
    assert all(s[k] is not a[k] and s[k] is not b[k] for k in s)
    assert int(a["tokens"]) == 0 and int(s["tokens"]) == 3
    assert s["expert_tokens"].tolist() == [6] + [0] * (E - 1)
    np.testing.assert_allclose(float(s["entropy_sum"]), 3 * np.log(E),
                               rtol=1e-6)


def _stats_pair(seed, n=16):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E, size=(n, K)).astype(np.int32)
    probs = rng.random(size=(n, E)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    vm = rng.random(n) < 0.8
    drop = np.int32(rng.integers(0, 4))
    sj = jdev.expert_stats(jnp.asarray(idx), jnp.asarray(probs), E,
                           jnp.asarray(vm), jnp.asarray(drop))
    st = tdev.expert_stats(torch.from_numpy(idx), torch.from_numpy(probs), E,
                           torch.from_numpy(vm), torch.tensor(drop))
    # the drains get the same numbers: JAX's entropy sum, bit for bit
    st["entropy_sum"] = torch.tensor(np.asarray(sj["entropy_sum"]))
    return sj, st


def test_drain_renders_jax_prometheus_text():
    """The same pushes (two flushes, one of them of two steps, then an
    empty flush) give byte-equal Prometheus text in both registries."""
    jr, tr = JReg(enabled=True), TReg(enabled=True)
    jd = jdev.RouterStatsDrain(jr, E, phase="serve")
    td = tdev.RouterStatsDrain(tr, E, phase="serve")
    for seeds in ((1, 2), (3,), ()):
        for s in seeds:
            sj, st = _stats_pair(s)
            jd.push(sj)
            td.push(st)
        jd.flush()
        td.flush()
        assert tr.render_prometheus() == jr.render_prometheus()
    assert td.total.tolist() == jd.total.tolist()
    assert td.total_tokens == jd.total_tokens > 0
    assert "repro_router_load_imbalance" in tr.render_prometheus()


def test_push_never_copies_to_the_host(monkeypatch):
    """``push`` keeps the device tensors themselves: no ``.cpu()``,
    ``.item()``, ``.tolist()``, ``.numpy()``, ``int()``, ``float()`` or
    ``bool()`` of a tensor happens in it (each is made to raise while it
    runs); ``flush`` alone reads them."""
    drain = tdev.RouterStatsDrain(TReg(enabled=True), E, phase="train")
    _, st = _stats_pair(7)

    def forbidden(*a, **k):
        raise AssertionError("push read a tensor back")

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "tolist", "numpy", "__int__",
                     "__float__", "__bool__", "__index__"):
            m.setattr(torch.Tensor, name, forbidden)
        drain.push(st)
        drain.push(None)
    assert len(drain._pending) == 1
    assert all(drain._pending[0][k] is st[k] for k in st)
    drain.flush()
    assert drain.total_tokens == int(st["tokens"]) and not drain._pending


def _moe_inputs(glu, seed=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"router": (rng.normal(size=(D, E)) * 0.5).astype(f32)}
    names = ((("w_gate", (E, D, F)), ("w_up", (E, D, F)),
              ("w_down", (E, F, D))) if glu else
             (("w1", (E, D, F)), ("b1", (E, F)), ("w2", (E, F, D)),
              ("b2", (E, D))))
    for name, shape in names:
        p[name] = (rng.normal(size=shape) * 0.2).astype(f32)
    x = rng.normal(size=(2, 12, D)).astype(f32)
    return x, p


@pytest.mark.parametrize("glu", [True, False])
def test_moe_layer_without_mesh_returns_the_stats(glu):
    """The step-0 repair: with the flag set and no mesh, ``moe_layer``
    returns JAX's 4-tuple; without it the 3-tuple, unchanged."""
    x, p = _moe_inputs(glu)
    jms = jmp.MoEStatic(num_experts=E, top_k=K, act="silu", glu=glu)
    tms = tmp.MoEStatic(E, K, act="silu", glu=glu)
    jcfg = JPC(blk=8, collect_router_stats=True)
    tcfg = TPC(blk=8, collect_router_stats=True)
    jout = jmp.moe_layer(jnp.asarray(x), jmp.MoEParams(
        **{k: jnp.asarray(v) for k, v in p.items()}), jms, jcfg, None,
        x_spec=P(None, None, None))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tout = tmp.moe_layer(torch.from_numpy(x), tp, tms, tcfg)
    assert len(jout) == len(tout) == 4
    for got, want in zip(tout[:3], jout[:3]):
        _close(got, want)
    assert_stats_equal(tout[3], jout[3])
    assert int(tout[3]["tokens"]) == 24
    assert len(tmp.moe_layer(torch.from_numpy(x), tp, tms, TPC(blk=8))) == 3


def test_ep_island_counts_capacity_drops_like_jax():
    """The "ep" island without a mesh (JAX's ``moe_layer`` runs it on its
    one-device mesh): at capacity factor 0.5 some token slots overflow,
    and the drops, counts and output equal JAX's."""
    x, p = _moe_inputs(True, seed=4)
    cf = 0.5
    jout = jmp.moe_layer(
        jnp.asarray(x), jmp.MoEParams(**{k: jnp.asarray(v)
                                         for k, v in p.items()}),
        jmp.MoEStatic(num_experts=E, top_k=K, act="silu", glu=True),
        JPC(blk=8, mode="ep", capacity_factor=cf,
            collect_router_stats=True), None, x_spec=P(None, None, None))
    tout = tmp.ep_moe_island(
        torch.from_numpy(x).reshape(-1, D),
        {k: torch.from_numpy(v) for k, v in p.items()},
        tmp.MoEStatic(E, K, act="silu", glu=True),
        TPC(blk=8, mode="ep", capacity_factor=cf, collect_router_stats=True))
    assert len(tout) == 4
    _close(tout[0], np.asarray(jout[0]).reshape(-1, D))
    assert_stats_equal(tout[3], jout[3])
    assert int(tout[3]["dropped_tokens"]) > 0


def _configs(arch, **kw):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32", **kw),
            dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32", **kw))


def _params(cj, ct, seed=0):
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(seed), cj))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), ct,
                               device="cpu")


@pytest.mark.parametrize("arch,remat", [(QWEN, "none"), (QWEN, "block"),
                                        ("gemma-2b", "none")])
def test_lm_forward_fifth_element_matches_jax(arch, remat):
    """``lm.forward`` grows JAX's fifth element: the stats summed over
    every MoE layer (through the remat'd training forward too); a dense
    stack gives ``zero_stats(1)`` in both."""
    cj, ct = _configs(arch, num_layers=2)
    pj, pt = _params(cj, ct)
    toks = np.random.default_rng(5).integers(
        0, cj.vocab_size, size=(2, 10)).astype(np.int32)
    jo = jlm.forward(pj, {"tokens": jnp.asarray(toks)}, cj,
                     JPC(blk=8, remat=remat, collect_router_stats=True),
                     None, mode="train")
    to = tlm.forward(pt, {"tokens": torch.from_numpy(toks)}, ct,
                     TPC(blk=8, remat=remat, collect_router_stats=True),
                     mode="train")
    assert len(jo) == len(to) == 5
    _close(to[0], jo[0], 1e-4)
    assert_stats_equal(to[4], jo[4])
    if ct.moe is None:
        assert to[4]["expert_tokens"].tolist() == [0]
    else:
        assert int(to[4]["tokens"]) == 2 * 10 * ct.num_layers
    assert len(tlm.forward(pt, {"tokens": torch.from_numpy(toks)}, ct,
                           TPC(blk=8), mode="train")) == 4


def test_train_step_metrics_carry_router_stats():
    cj, ct = _configs(QWEN, num_layers=2)
    pj, pt = _params(cj, ct)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cj.vocab_size, size=(2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 16), np.float32)}
    opt = jadamw.OptimizerConfig()
    jstep = jax.jit(jsteps.make_train_step(
        cj, JPC(blk=8, collect_router_stats=True), None, opt, (2, 16, 64)))
    _, _, jm = jstep(pj, jadamw.init_opt_state(pj, opt),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    topt = tadamw.OptimizerConfig()
    tstep = tsteps.make_train_step(ct, TPC(blk=8, collect_router_stats=True),
                                   topt)
    _, _, tm = tstep(pt, tadamw.init_opt_state(pt, topt),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_stats_equal(tm["router_stats"], jm["router_stats"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert set(tm) == set(jm)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_dense_steps_return_the_stats_third(mode):
    cj, ct = _configs(QWEN, num_layers=2)
    pj, pt = _params(cj, ct)
    b, s, max_seq = 2, 6, 16
    toks = np.random.default_rng(8).integers(
        0, cj.vocab_size, size=(b, s if mode == "prefill" else 1)
    ).astype(np.int32)
    make_j = (jsteps.make_prefill_step if mode == "prefill"
              else jsteps.make_serve_step)
    make_t = (tsteps.make_prefill_step if mode == "prefill"
              else tsteps.make_serve_step)
    jout = make_j(cj, JPC(blk=8, collect_router_stats=True), None,
                  (b, toks.shape[1], cj.d_model))(
        pj, {"tokens": jnp.asarray(toks)}, jlm.init_cache(cj, b, max_seq))
    tout = make_t(ct, TPC(blk=8, collect_router_stats=True))(
        pt, {"tokens": torch.from_numpy(toks)},
        tlm.init_cache(ct, b, max_seq, "cpu"))
    assert len(jout) == len(tout) == 3
    _close(tout[0], jout[0], 1e-4)
    assert_stats_equal(tout[2], jout[2])
