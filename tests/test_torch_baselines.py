"""PyTorch port vs the JAX package: the paper's baselines (``core/
baselines.py``: Tutel-style dispatch/combine and MegaBlocks-style grouped
dense GEMM) and Swin-MoE run through them.

Same numpy inputs (and the same ``RouterOutput``, built from the same
expert ids and gates) through ``repro.core.baselines`` and its port on
the CPU:

* ``_dispatch_ranks`` bitwise, with ties (many copies to few experts);
* ``tutel_capacity``: the JAX package's integer ceil, float product and
  floor;
* ``dispatch_combine_moe`` at capacity factor 1.25 and at a capacity that
  drops, with and without biases, with ``glu_up``; ``grouped_dense_moe``;
  the grads of x, w1, b1, w2, b2 and the gates against ``jax.grad``;
* the port's megablocks against its own hexa layer (``espec.
  hexa_moe_ffn``; the counterpart of ``tests/test_moe_equivalence.py::
  test_hexa_equals_no_drop_dispatch``), and tutel against megablocks: with
  an ample capacity equal, with a tight one equal to megablocks with the
  dropped copies' gates set to 0;
* ``swin_forward`` and ``make_train_step`` with ``moe_impl="tutel"`` and
  ``"megablocks"`` on both smoke configurations against the JAX model,
  weights carried over by ``swin_params_from_jax``; ``swin_forward``
  also through ``"hexa"``, and through all three at the grid points of
  the paper's Tables 7/8 past top-2 (4 experts top-3 and top-4, 8 experts
  top-8), where tutel's capacity and megablocks' E N k rows grow with k.

Tolerances: f32 outputs at 1e-5 x max|ref| (the same products, summed in
another order), grads at 1e-5 x max|ref|; hexa against megablocks at
2e-5 (as the JAX package's own check; hexa sums blocks of sorted rows);
tutel against megablocks exactly (the same buffer rows, the same
products); Swin logits at 1e-5 x max|ref| and aux/z at 1e-6 relative,
train losses within 1e-5 relative and grad norms within 1e-4, as
``tests/test_torch_swin.py`` holds the hexa path.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import cdiv as jcdiv
from repro.configs import swin_moe_base as jsb
from repro.configs import swin_moe_small as jss
from repro.core import baselines as jbl
from repro.core.routing import RouterOutput as JRouterOutput
from repro.models import swin as jswin
from repro.optim import adamw as jadamw
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch.common import ACTIVATIONS, tree_map
from repro_torch.configs import swin_moe_base as tsb
from repro_torch.configs import swin_moe_small as tss
from repro_torch.convert import swin_params_from_jax
from repro_torch.core import baselines as tbl
from repro_torch.core import espec
from repro_torch.core.routing import RouterOutput, route
from repro_torch.models import swin as tswin
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

GELU_T = ACTIVATIONS["gelu"]          # tanh form, as jax.nn.gelu
N, D, F, E, K = 48, 16, 24, 4, 2


def _close(got, want, tol_rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_rel * scale)


def _layer(seed, n=N, d=D, f=F, e=E, k=K, skew=False):
    """x, expert ids (N, k) (distinct within a token; with ``skew`` most
    copies go to expert 0, so a tight capacity drops), gates and the
    expert weights, all numpy f32 / int32."""
    rng = np.random.default_rng(seed)
    p = np.full(e, 1.0 / e) if not skew else np.r_[0.7, np.full(e - 1, 0.3
                                                                / (e - 1))]
    idx = np.stack([rng.choice(e, size=k, replace=False, p=p)
                    for _ in range(n)]).astype(np.int32)
    gates = rng.uniform(0.2, 1.0, size=(n, k)).astype(np.float32)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(
        x=f32(rng.normal(size=(n, d))), idx=idx, gates=gates,
        w1=f32(rng.normal(size=(e, d, f)) * 0.2),
        b1=f32(rng.normal(size=(e, f)) * 0.2),
        w2=f32(rng.normal(size=(e, f, d)) * 0.2),
        b2=f32(rng.normal(size=(e, d)) * 0.2),
        up=f32(rng.normal(size=(e, d, f)) * 0.2))


def _routers(lay):
    zero_j, zero_t = jnp.zeros(()), torch.zeros(())
    rj = JRouterOutput(jnp.asarray(lay["idx"]), jnp.asarray(lay["gates"]),
                       zero_j, zero_j, None)
    rt = RouterOutput(torch.from_numpy(lay["idx"]),
                      torch.from_numpy(lay["gates"]), zero_t, zero_t, None)
    return rj, rt


@pytest.mark.parametrize("n,k,e,seed", [(48, 2, 4, 0), (7, 3, 3, 1),
                                        (64, 1, 8, 2), (33, 2, 2, 3)])
def test_dispatch_ranks_bitwise_with_ties(n, k, e, seed):
    """Every expert gets many copies (ties in the sort key): the stable
    sort keeps them in flat (token, slot) order, as ``jnp.argsort(stable=
    True)`` does; ranks and counts are the same integers."""
    idx = np.random.default_rng(seed).integers(0, e, size=(n, k)) \
        .astype(np.int32)
    rj, cj = jbl._dispatch_ranks(jnp.asarray(idx), e)
    rt, ct = tbl._dispatch_ranks(torch.from_numpy(idx), e)
    assert rt.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("n,k,e,cf", [(48, 2, 4, 1.25), (10, 1, 4, 1.25),
                                      (7, 3, 8, 0.3), (5, 1, 8, 0.01),
                                      (100, 2, 8, 1.0), (9, 2, 4, 2.5)])
def test_tutel_capacity_takes_the_jax_roundings(n, k, e, cf):
    """``int(cdiv(n*k, E) * cf)``, at least 1: 10 copies over 4 experts
    at 1.25 give int(3 * 1.25) = 3, not ceil(10 / 4 * 1.25) = 4."""
    assert tbl.tutel_capacity(n, k, e, cf) == max(
        int(jcdiv(n * k, e) * cf), 1)
    assert tbl.tutel_capacity(10, 1, 4, 1.25) == 3


# (capacity, biases, glu_up): 1.25's capacity, a tight one that drops,
# no biases, the GLU form
DISPATCH_CASES = [(None, True, False), (3, True, False), (None, False, False),
                  (3, False, True), (None, True, True)]


@pytest.mark.parametrize("cap,bias,glu", DISPATCH_CASES)
def test_dispatch_combine_matches_jax(cap, bias, glu):
    lay = _layer(10, skew=cap is not None)
    rj, rt = _routers(lay)
    kw_j = dict(act=jax.nn.gelu, capacity=cap,
                glu_up=jnp.asarray(lay["up"]) if glu else None)
    kw_t = dict(act=GELU_T, capacity=cap,
                glu_up=torch.from_numpy(lay["up"]) if glu else None)
    b1, b2 = (lay["b1"], lay["b2"]) if bias else (None, None)
    want = jbl.dispatch_combine_moe(
        jnp.asarray(lay["x"]), rj, jnp.asarray(lay["w1"]),
        None if b1 is None else jnp.asarray(b1), jnp.asarray(lay["w2"]),
        None if b2 is None else jnp.asarray(b2), **kw_j)
    got = tbl.dispatch_combine_moe(
        torch.from_numpy(lay["x"]), rt, torch.from_numpy(lay["w1"]),
        None if b1 is None else torch.from_numpy(b1),
        torch.from_numpy(lay["w2"]),
        None if b2 is None else torch.from_numpy(b2), **kw_t)
    assert got.shape == (N, D) and got.dtype == torch.float32
    _close(got, want, 1e-5)
    if cap is not None:          # the tight capacity did drop copies
        rank, _ = tbl._dispatch_ranks(rt.expert_idx, E)
        assert int((rank >= cap).sum()) > 0


@pytest.mark.parametrize("bias,glu", [(True, False), (False, False),
                                      (True, True)])
def test_grouped_dense_matches_jax(bias, glu):
    lay = _layer(11)
    rj, rt = _routers(lay)
    b1, b2 = (lay["b1"], lay["b2"]) if bias else (None, None)
    want = jbl.grouped_dense_moe(
        jnp.asarray(lay["x"]), rj, jnp.asarray(lay["w1"]),
        None if b1 is None else jnp.asarray(b1), jnp.asarray(lay["w2"]),
        None if b2 is None else jnp.asarray(b2), act=jax.nn.gelu,
        glu_up=jnp.asarray(lay["up"]) if glu else None)
    got = tbl.grouped_dense_moe(
        torch.from_numpy(lay["x"]), rt, torch.from_numpy(lay["w1"]),
        None if b1 is None else torch.from_numpy(b1),
        torch.from_numpy(lay["w2"]),
        None if b2 is None else torch.from_numpy(b2), act=GELU_T,
        glu_up=torch.from_numpy(lay["up"]) if glu else None)
    _close(got, want, 1e-5)


GRAD_ARGS = ("x", "w1", "b1", "w2", "b2", "gates")


@pytest.mark.parametrize("impl,cap", [("tutel", None), ("tutel", 3),
                                      ("megablocks", None)])
def test_grads_match_jax(impl, cap):
    """d/d(x, w1, b1, w2, b2, gates) of sum(y * c) for a fixed c, against
    ``jax.grad``; a dropped copy's gate gets 0 on both sides."""
    lay = _layer(12, skew=cap is not None)
    c = np.random.default_rng(13).normal(size=(N, D)).astype(np.float32)

    def jloss(x, w1, b1, w2, b2, gates):
        r = JRouterOutput(jnp.asarray(lay["idx"]), gates, 0.0, 0.0, None)
        if impl == "tutel":
            y = jbl.dispatch_combine_moe(x, r, w1, b1, w2, b2,
                                         act=jax.nn.gelu, capacity=cap)
        else:
            y = jbl.grouped_dense_moe(x, r, w1, b1, w2, b2, act=jax.nn.gelu)
        return jnp.sum(y * c)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(lay[a]) for a in GRAD_ARGS))
    ts = [torch.from_numpy(lay[a]).requires_grad_() for a in GRAD_ARGS]
    r = RouterOutput(torch.from_numpy(lay["idx"]), ts[5], None, None, None)
    if impl == "tutel":
        y = tbl.dispatch_combine_moe(*ts[:1], r, *ts[1:5], act=GELU_T,
                                     capacity=cap)
    else:
        y = tbl.grouped_dense_moe(*ts[:1], r, *ts[1:5], act=GELU_T)
    got = torch.autograd.grad((y * torch.from_numpy(c)).sum(), ts)
    for name, g, w in zip(GRAD_ARGS, got, want):
        assert g.shape == tuple(w.shape), name
        _close(g, w, 1e-5)


def _hexa_params(lay):
    rng = np.random.default_rng(14)
    router = (rng.normal(size=(D, E)) * 0.2).astype(np.float32)
    p = {k: torch.from_numpy(lay[k]) for k in ("w1", "b1", "w2", "b2")}
    return {"router": torch.from_numpy(router), **p}


def test_megablocks_equals_the_hexa_layer():
    """No copy drops with the worst-case capacity, so megablocks computes
    what the expert-specific layer computes (and hexa pads at most BLK-1
    rows an expert, where megablocks pads (E-1) N k)."""
    lay = _layer(15)
    p = _hexa_params(lay)
    x = torch.from_numpy(lay["x"])
    out = espec.hexa_moe_ffn(x, p, num_experts=E, top_k=K, act="gelu",
                             glu=False, blk=8)
    r = route(x, p["router"], K)
    base = tbl.grouped_dense_moe(x, r, p["w1"], p["b1"], p["w2"], p["b2"],
                                 act=GELU_T)
    _close(base, out.y.detach(), 2e-5)


def test_tutel_equals_megablocks_or_drops_gates():
    """With an ample capacity tutel is megablocks, bit for bit; with a
    tight one it is megablocks with the dropped copies' gates set to 0."""
    lay = _layer(16, skew=True)
    _, r = _routers(lay)
    args = [torch.from_numpy(lay[k]) for k in ("x", "w1", "b1", "w2", "b2")]
    mb = tbl.grouped_dense_moe(args[0], r, *args[1:], act=GELU_T)
    ample = tbl.dispatch_combine_moe(args[0], r, *args[1:], act=GELU_T,
                                     capacity_factor=float(E))
    assert torch.equal(ample, mb)
    cap = 3
    tight = tbl.dispatch_combine_moe(args[0], r, *args[1:], act=GELU_T,
                                     capacity=cap)
    rank, _ = tbl._dispatch_ranks(r.expert_idx, E)
    assert int((rank >= cap).sum()) > 0
    r0 = r._replace(gates=torch.where(rank < cap, r.gates, 0.0))
    _close(tight, tbl.grouped_dense_moe(args[0], r0, *args[1:], act=GELU_T),
           1e-6)
    assert float((tight - mb).abs().max()) > 1e-3


CONFIGS = {"small": (jss.SMOKE_CONFIG, tss.SMOKE_CONFIG),
           "base": (jsb.SMOKE_CONFIG, tsb.SMOKE_CONFIG)}
JPCFG = JPC(blk=8, impl="pallas", fused_ffn=True)
TPCFG = TPC(blk=8)
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4, master_fp32=False)


def _swin_params(cfg, seed):
    """The port's init in the JAX layout, every leaf nudged by seeded
    noise (as ``tests/test_torch_swin.py`` draws them)."""
    pt = tswin.init_swin(dataclasses.replace(cfg, dtype="float32"),
                         generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: (t.numpy() + rng.normal(size=t.shape) * 0.05)
                    .astype(np.float32), pt)


def _images(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.img_size, cfg.img_size, cfg.in_chans))
            .astype(np.float32),
            rng.integers(0, cfg.num_classes, size=b).astype(np.int32))


# (impl, config, (experts, top-k) or None for the smoke config's 4 top-2);
# the first four keep their ids from before the grid points were added
SWIN_FORWARD_CASES = [
    pytest.param(impl, which, None, id=f"{impl}-{which}")
    for impl in ("tutel", "megablocks", "hexa")
    for which in ("small", "base")] + [
    pytest.param(impl, "small", (e, k), id=f"{impl}-small-e{e}-top{k}")
    for e, k in ((4, 3), (4, 4), (8, 8))
    for impl in ("hexa", "tutel", "megablocks")]


@pytest.mark.parametrize("impl,which,point", SWIN_FORWARD_CASES)
def test_swin_forward_baselines_match_jax(impl, which, point):
    cfg_j, cfg_t = CONFIGS[which]
    if point is not None:
        cfg_j, cfg_t = jss.with_experts(cfg_j, *point), \
            tss.with_experts(cfg_t, *point)
    pj = _swin_params(cfg_t, seed=20)
    imgs, _ = _images(cfg_j, 4, seed=21)
    lj, aj, zj = jax.jit(functools.partial(
        jswin.swin_forward, cfg=cfg_j, pcfg=JPCFG, moe_impl=impl))(
        jax.tree.map(jnp.asarray, pj), jnp.asarray(imgs))
    pt = swin_params_from_jax(pj, cfg_t, device="cpu")
    lt, at, zt = tswin.swin_forward(pt, torch.from_numpy(imgs), cfg_t, TPCFG,
                                    moe_impl=impl)
    assert lt.shape == (4, cfg_t.num_classes)
    _close(lt, lj, 1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    np.testing.assert_allclose(float(zt), float(zj), rtol=1e-6)


@pytest.mark.parametrize("impl", ["tutel", "megablocks"])
def test_swin_train_steps_baselines_match_jax(impl):
    """Two AdamW steps of ``make_train_step(..., moe_impl=impl)`` against
    ``benchmarks/memory_table.py::make_train_fn``'s JAX step."""
    cfg_j, cfg_t = CONFIGS["small"]
    ocj, oct_ = jadamw.OptimizerConfig(**OPT), tadamw.OptimizerConfig(**OPT)

    def loss_fn(params, images, labels):
        logits, aux, _ = jswin.swin_forward(params, images, cfg_j, JPCFG,
                                            None, moe_impl=impl)
        onehot = jax.nn.one_hot(labels, cfg_j.num_classes)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return ce + 0.01 * aux

    @jax.jit
    def step_j(params, opt, images, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, labels)
        params, opt, m = jadamw.apply_updates(params, grads, opt, ocj)
        return params, opt, loss, m

    pj = jax.tree.map(jnp.asarray, _swin_params(cfg_t, seed=22))
    pt = swin_params_from_jax(pj, cfg_t, device="cpu")
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    step_t = tswin.make_train_step(cfg_t, TPCFG, oct_, moe_impl=impl)
    for step in range(2):
        imgs, labels = _images(cfg_j, 4, seed=23 + step)
        pj, oj, lj, mj = step_j(pj, oj, jnp.asarray(imgs),
                                jnp.asarray(labels))
        pt, ot, mt = step_t(pt, ot, torch.from_numpy(imgs),
                            torch.from_numpy(labels))
        np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
