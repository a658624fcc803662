"""PyTorch port vs the JAX package: the training slice.

Same numpy inputs and the same weights (carried over by
``params_from_jax``) through the JAX functions and their ports, on the
CPU, where every port kernel wrapper runs its plain version:

* autograd grads of ``ops.esffn_glu`` (through ``espec.moe_glu``, fused)
  and ``ops.esmm`` (the unfused ``moe_glu``, and alone in both weight
  orientations) against ``jax.grad`` of the JAX ops (``impl="pallas"``,
  interpret mode, blk 8) for x, the routing gates and the three weights;
* ``chunked_attention`` forward and grads (one case with a prefix-LM
  mask longer than the query chunk);
* ``adamw.apply_updates`` on identical grads (schedule, clip, decay mask,
  f32 masters of bf16 parameters), the synthetic ``TokenSource``;
* the whole train step: 3 steps of the port's ``make_train_step`` against
  the JAX ``make_train_step`` (mesh None, ``impl="pallas"`` in interpret
  mode, blk 8) on the f32 smoke configs, from the same weights, batches
  and zero optimizer state; one bf16 step from a converted JAX state
  (``opt_state_from_jax``); ``remat="block"`` against ``"none"``;
* the train CLI's contract.

Tolerances: f32 at 1e-5 (losses relative; grads and attention at
rtol 1e-5 + atol 1e-6 x max|ref|), which only summation order separates.
bf16 grads at 3e-2 x max|ref|: g, u, h and the ESMM outputs round to bf16
after f32 sums taken in another order. The bf16 train step at 2e-3
relative on the loss and 2e-2 on the grad norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.core import espec as jespec
from repro.core import reindex as jri
from repro.data.pipeline import DataConfig as JDC, TokenSource as JTS
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.common import tree_leaves, tree_map
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import espec as tespec
from repro_torch.core import reindex as tri
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
N, D, F, E, K, BLK = 9, 16, 32, 4, 2, 8
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}   # x max|ref|


def _t(a, dtype="float32", grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


def _close(got, want, tol_rel, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=tol_rel * scale)


def _moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(N) % E, (rng.permutation(N) + 1) % E],
                   1).astype(np.int32)
    idx[idx == 1] = 3                         # expert 1 gets no rows
    return {
        "idx": idx,
        "gates": rng.random((N, K)).astype(np.float32),
        "x": rng.normal(size=(N, D)).astype(np.float32),
        "w_gate": (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32),
        "w_up": (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32),
        "w_down": (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32),
        "ct": rng.normal(size=(N, D)).astype(np.float32),
    }


@pytest.mark.parametrize("fused,dtype", [(True, "float32"),
                                         (False, "float32"),
                                         (True, "bfloat16")])
def test_moe_glu_grads_match_jax(fused, dtype):
    """Grads of sum(moe_glu(x) * ct) for x, the gates (through the
    re-index gather into row_gate) and the three weights: the fused op's
    flash-style backward, and the unfused ESMM chain."""
    a = _moe_inputs()
    jdt = getattr(jnp, dtype)
    names = ("x", "gates", "w_gate", "w_up", "w_down")

    def jloss(x, gates, wg, wu, wd):
        ri = jri.build_reindex(jnp.asarray(a["idx"]), gates, E, BLK)
        y = jespec.moe_glu(x, ri, wg, wu, wd, impl="pallas", fused=fused)
        return jnp.sum(y.astype(jnp.float32) * a["ct"])

    jargs = [jnp.asarray(a[k], jnp.float32 if k == "gates" else jdt)
             for k in names]
    want = jax.grad(jloss, argnums=tuple(range(5)))(*jargs)

    targs = [_t(a[k], "float32" if k == "gates" else dtype, grad=True)
             for k in names]
    x, gates, wg, wu, wd = targs
    ri = tri.build_reindex(torch.from_numpy(a["idx"]), gates, E, BLK)
    y = tespec.moe_glu(x, ri, wg, wu, wd, fused=fused)
    (y.float() * torch.from_numpy(a["ct"])).sum().backward()
    for name, t, w in zip(names, targs, want):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, w, GRAD_TOL[dtype])
    # expert 1 got no rows: exactly-0 weight grads
    for t in (wg, wu, wd):
        assert (t.grad[1] == 0).all()


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_esmm_grads_match_jax(transpose_rhs):
    a = _moe_inputs(1)
    jr = jri.build_reindex(jnp.asarray(a["idx"]), jnp.asarray(a["gates"]), E,
                           BLK)
    tr = tri.build_reindex(torch.from_numpy(a["idx"]),
                           torch.from_numpy(a["gates"]), E, BLK)
    xs = np.asarray(jri.gather_rows(jnp.asarray(a["x"]), jr.row_token))
    w = a["w_gate"].transpose(0, 2, 1) if transpose_rhs else a["w_gate"]
    ct = np.random.default_rng(2).normal(size=(jr.num_rows, F))

    def jloss(xs_, w_):
        y = jops.esmm(xs_, w_, None, jr.block_expert, jr.padded_counts,
                      transpose_rhs=transpose_rhs, impl="pallas")
        return jnp.sum(y * ct)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(w))
    xs_t, w_t = _t(xs, grad=True), _t(w, grad=True)
    y = tops.esmm(xs_t, w_t, None, tr.block_expert, tr.padded_counts,
                  transpose_rhs=transpose_rhs)
    (y * torch.from_numpy(ct)).sum().backward()
    _close(xs_t.grad, want[0], GRAD_TOL["float32"])
    _close(w_t.grad, want[1], GRAD_TOL["float32"])


# ids as before the prefix case was added, so each case keeps its name
@pytest.mark.parametrize("window,q_chunk,kv_block,softcap,prefix_len", [
    (None, 2048, 2048, 0.0, 0),
    (None, 8, 4, 0.0, 0),
    (8, 8, 4, 0.0, 0),
    (12, 16, 8, 30.0, 0),
    (None, 8, 4, 0.0, 12),
], ids=["None-2048-2048-0.0", "None-8-4-0.0", "8-8-4-0.0", "12-16-8-30.0",
        "prefix12-8-4"])
def test_chunked_attention_matches_jax(window, q_chunk, kv_block, softcap,
                                       prefix_len):
    """The prefix case runs a q_chunk (8) shorter than the prefix (12):
    chunk 0 reads keys up to its own end only, in both packages."""
    b, s, hq, hkv, hd = 2, 32, 4, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    ct = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=q_chunk,
              kv_block=kv_block, softcap=softcap, prefix_len=prefix_len)

    def jloss(q_, k_, v_):
        out = jattn.chunked_attention(q_, k_, v_, **kw)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, 1e-6, rtol=1e-5)
    for t, w in zip((tq, tk, tv), jg):
        _close(t.grad, w, 1e-6, rtol=1e-5)


def test_cross_entropy_matches_jax():
    """``xent_loss`` and ``chunked_xent`` (hidden states through the untied
    head, 4 chunks, a partial mask) and their grads."""
    cfg_j = dataclasses.replace(
        jcfglib.get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32")
    rng = np.random.default_rng(9)
    b, s, d, v = 2, 8, cfg_j.d_model, cfg_j.vocab_size
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    logits = rng.normal(size=(b, s, v)).astype(np.float32) * 3

    np.testing.assert_allclose(
        float(tsteps.xent_loss(_t(logits), torch.from_numpy(labels),
                               torch.from_numpy(mask))),
        float(jsteps.xent_loss(jnp.asarray(logits), labels, mask)),
        rtol=1e-6)

    def jloss(x_, head_):
        return jsteps.chunked_xent(x_, {"head": head_}, cfg_j, labels, mask,
                                   n_chunks=4)

    want, (gx, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(x, head)
    tx, th = _t(x, grad=True), _t(head, grad=True)
    cfg_t = dataclasses.replace(
        tcfglib.get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32")
    got = tsteps.chunked_xent(tx, {"head": th}, cfg_t, torch.from_numpy(
        labels), torch.from_numpy(mask), n_chunks=4)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _close(tx.grad, gx, 1e-6, rtol=1e-5)
    _close(th.grad, gh, 1e-6, rtol=1e-5)


def _opt_tree(rng, scale=1.0):
    """A small parameter-shaped tree: a bf16 matrix (master + decay), an
    f32 vector (no decay), and a layer list."""
    return {
        "embed": (rng.normal(size=(6, 4)) * scale).astype(np.float32),
        "final_norm": {"scale": (rng.normal(size=(4,)) * scale)
                       .astype(np.float32)},
        "layers": [{"w": (rng.normal(size=(3, 4, 2)) * scale)
                    .astype(np.float32)} for _ in range(2)],
    }


def test_adamw_matches_jax():
    """Identical grads into both optimizers over 6 steps that cross the
    warmup, cosine and post-decay parts of the schedule, with the clip
    active on some steps (large grads) and idle on others."""
    cfg = dict(peak_lr=1e-2, min_lr=1e-3, warmup_steps=2, decay_steps=4,
               grad_clip=1.0, weight_decay=0.1)
    jcfg, tcfg = jadamw.OptimizerConfig(**cfg), tadamw.OptimizerConfig(**cfg)
    rng = np.random.default_rng(4)
    p0 = _opt_tree(rng)
    bf16 = {"embed", "w"}
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            a, jnp.bfloat16 if str(path[-1].key) in bf16 else jnp.float32), p0)

    def tconv(a, key):
        return _t(a, "bfloat16" if key in bf16 else "float32")

    tp = {"embed": tconv(p0["embed"], "embed"),
          "final_norm": {"scale": tconv(p0["final_norm"]["scale"], "scale")},
          "layers": [{"w": tconv(layer["w"], "w")} for layer in p0["layers"]]}
    js, ts = jadamw.init_opt_state(jp, jcfg), tadamw.init_opt_state(tp, tcfg)
    assert ts["master"]["final_norm"]["scale"] is None
    assert ts["master"]["embed"].dtype == torch.float32
    for step in range(6):
        g = _opt_tree(rng, scale=5.0 if step % 2 else 0.01)
        jg = jax.tree.map(jnp.asarray, g)
        tg = {"embed": _t(g["embed"], "bfloat16"),
              "final_norm": {"scale": _t(g["final_norm"]["scale"])},
              "layers": [{"w": _t(layer["w"], "bfloat16")}
                         for layer in g["layers"]]}
        jg = jax.tree.map(lambda a, p: a.astype(p.dtype), jg, jp)
        jp, js, jm = jadamw.apply_updates(jp, jg, js, jcfg)
        tp, ts, tm = tadamw.apply_updates(tp, tg, ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for key in ("m", "v", "master"):
            for a, b in zip(tree_leaves(ts[key]), jax.tree.leaves(
                    js[key], is_leaf=lambda x: x is None)):
                if a is None:
                    assert b is None
                    continue
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-12)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            # bf16 parameters: the master's rounding; at most one bf16 ulp
            # from JAX's where the masters differ in their last f32 bit
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-6 if a.dtype == torch.float32
                                       else 2 ** -8)
        for a, ma in zip(tree_leaves(tp), tree_leaves(ts["master"])):
            if ma is not None:
                assert torch.equal(a, ma.to(a.dtype))


@pytest.mark.parametrize("vocab,seed", [(128, 0), (151936, 3)])
def test_token_source_bit_identical(vocab, seed):
    j = JTS(JDC(seq_len=24, global_batch=3, vocab_size=vocab, seed=seed))
    t = TokenSource(DataConfig(seq_len=24, global_batch=3, vocab_size=vocab,
                               seed=seed))
    for step in (0, 5):
        jb, tb = j.batch(step), t.batch(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def _setup(arch, dtype, batch=2, seq=32):
    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch), dtype=dtype)
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch), dtype=dtype)
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    opt = dict(peak_lr=3e-4, warmup_steps=2, decay_steps=6)
    ocj, oct_ = jadamw.OptimizerConfig(**opt), tadamw.OptimizerConfig(**opt)
    step_j = jax.jit(jsteps.make_train_step(
        cfg_j, JPC(blk=8, impl="pallas"), None, ocj,
        (batch, seq, cfg_j.d_model)))
    step_t = tsteps.make_train_step(cfg_t, TPC(blk=8), oct_)
    src = TokenSource(DataConfig(seq_len=seq, global_batch=batch,
                                 vocab_size=cfg_t.vocab_size, seed=1))
    return cfg_j, cfg_t, pj, pt, ocj, oct_, step_j, step_t, src


def _batches(src, step):
    b = src.batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """3 AdamW steps from the same weights, batches and zero optimizer
    state: losses within 1e-5 relative of the JAX train step."""
    _, _, pj, pt, ocj, oct_, step_j, step_t, src = _setup(arch, "float32")
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    for step in range(3):
        bj, bt = _batches(src, step)
        pj, oj, mj = step_j(pj, oj, bj)
        pt, ot, mt = step_t(pt, ot, bt)
        for key in ("loss", "total_loss", "aux_loss", "z_loss"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)


def test_bf16_step_from_converted_jax_state():
    """JAX takes one bf16 step; its parameters and optimizer state carry
    over (``opt_state_from_jax``, checked leaf for leaf) and both take the
    next step: loss within 2e-3 relative, grad norm within 2e-2."""
    cfg_j, cfg_t, pj, _, ocj, _, step_j, step_t, src = _setup(
        "qwen3-moe-30b-a3b", "bfloat16")
    oj = jadamw.init_opt_state(pj, ocj)
    pj, oj, _ = step_j(pj, oj, _batches(src, 0)[0])
    nj = jax.tree.map(np.asarray, (pj, oj))
    pt = params_from_jax(nj[0], cfg_t, device="cpu")
    ot = opt_state_from_jax(nj[1], cfg_t, device="cpu")

    assert int(ot["step"]) == 1 and ot["step"].dtype == torch.int32
    period = cfg_t.period
    for key in ("m", "v", "master"):
        jt = nj[1][key]
        for li, layer in enumerate(ot[key]["layers"]):
            pp, pos = divmod(li, period)
            jl = jax.tree.leaves(jt["layers"][pos],
                                 is_leaf=lambda x: x is None)
            for a, b in zip(tree_leaves(layer), jl):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a.float().numpy(),
                                                  np.asarray(b[pp],
                                                             np.float32))
        for name in ("embed", "head"):
            np.testing.assert_array_equal(ot[key][name].float().numpy(),
                                          np.asarray(jt[name], np.float32))
    assert ot["master"]["final_norm"]["scale"] is None
    assert ot["master"]["embed"].dtype == torch.float32

    bj, bt = _batches(src, 1)
    pj, oj, mj = step_j(pj, oj, bj)
    pt, ot, mt = step_t(pt, ot, bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=2e-2)
    assert int(ot["step"]) == 2


def test_remat_block_equals_none():
    """Recomputing each block in the backward changes no grad."""
    cfg = dataclasses.replace(tcfglib.get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32")
    params, _ = ttrain.build_state(cfg, tadamw.OptimizerConfig(), 0, "cpu")
    batch = ttrain.batch_to(TokenSource(DataConfig(
        seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)).batch(0),
        "cpu")
    out = {}
    for remat in ("block", "none"):
        tree = tree_map(lambda p: p.detach().clone().requires_grad_(),
                        params)
        leaves = tree_leaves(tree)
        total, _ = tsteps.make_loss_fn(cfg, TPC(blk=8, remat=remat))(tree,
                                                                    batch)
        out[remat] = (float(total.detach()),
                      torch.autograd.grad(total, leaves))
    assert out["block"][0] == out["none"][0]
    for a, b in zip(out["block"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        TPC(remat="full")


def test_train_cli_contract(tmp_path, monkeypatch, capsys):
    """GPU unless ``--device cpu``; raises without one; later-slice flags
    are absent, not accepted and ignored."""
    out = tmp_path / "m.json"
    log = ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                       "2", "--global-batch", "2", "--seq-len", "16",
                       "--layers", "1", "--device", "cpu", "--metrics-out",
                       str(out)])
    assert [m["step"] for m in log] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in log) and out.exists()
    assert "[train] finished at step 2" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                     "1"])


# --overlap-dispatch, --topology and the fault-tolerance and obs flags are
# ported: misused, they are JAX's argparse errors (exit 2); --impl and
# --no-scan have no counterpart and stay absent
@pytest.mark.parametrize("flag", [
    ["--simulate-skew", "1,2"],
    ["--hetero-replan", "--simulate-skew", "1,x"], ["--overlap-dispatch"],
    ["--topology", "1:1"], ["--elastic"],
    ["--metrics-interval", "x"], ["--save-every", "x"],
    ["--resume", "--no-scan"], ["--impl", "pallas"]])
def test_train_cli_later_slice_flags_absent(flag):
    with pytest.raises(SystemExit) as err:
        ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                     "cpu", *flag])
    assert err.value.code == 2
