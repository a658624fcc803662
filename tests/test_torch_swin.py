"""PyTorch port vs the JAX package: Swin-MoE, the paper's benchmark model.

Same numpy inputs and the same weights (carried over by
``swin_params_from_jax``; the zero-initialised biases and unit norm
scales are perturbed first so that every leaf matters) through
``repro.models.swin`` and its port on the CPU, where every port kernel
wrapper runs its plain version:

* ``swin_forward`` logits, aux and z on ``swin_moe_small.SMOKE_CONFIG``
  and ``swin_moe_base.SMOKE_CONFIG`` (the JAX side through the Pallas
  kernels in interpret mode, fused FFN, blk 8), and in bf16;
* one test per semantic trap: the population variance of the layer
  norm, the tanh gelu, the shifted window's roll without a mask and the
  clamped window, f32 logits with ``attn`` cast back, top-1 gates of 1,
  the patch embedding as a matmul (no TF32 convolution);
* 3 AdamW steps of ``make_train_step`` against the JAX step built here
  as ``benchmarks/memory_table.py::make_train_fn`` builds it (ce + 0.01
  aux, ``master_fp32=False``), and one step from a JAX state carried
  over by ``swin_opt_state_from_jax``; the unfused backward (ESTMM + ESS)
  against the fused one.

Tolerances: f32 logits at 1e-5 x max|ref| and aux/z at 1e-6 relative
(summation order only); f32 losses within 1e-5 relative over 3 steps,
grad norms within 1e-4; bf16 logits at 3e-2 x max|ref| (activations
round to bf16 after sums taken in another order, across 5 blocks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import swin_moe_base as jsb
from repro.configs import swin_moe_small as jss
from repro.models import swin as jswin
from repro.optim import adamw as jadamw
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs import swin_moe_base as tsb
from repro_torch.configs import swin_moe_small as tss
from repro_torch.convert import swin_opt_state_from_jax, swin_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models import swin as tswin
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

CONFIGS = {"small": (jss.SMOKE_CONFIG, tss.SMOKE_CONFIG),
           "base": (jsb.SMOKE_CONFIG, tsb.SMOKE_CONFIG)}
JPCFG = JPC(blk=8, impl="pallas", fused_ffn=True)
TPCFG = TPC(blk=8)
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4, master_fp32=False)


def _params(cfg, seed=0):
    """A parameter tree in the JAX layout (dicts, ``stages``/``blocks``
    lists, f32 numpy leaves): the port's init (the JAX init's tree, as
    ``test_init_swin_has_the_jax_tree`` checks), every leaf nudged by
    seeded noise so that the zero biases and unit scales matter."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    pt = tswin.init_swin(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: (t.numpy() + rng.normal(size=t.shape) * 0.05)
                    .astype(np.float32), pt)


def _jax_shapes(cfg_j):
    return jax.eval_shape(lambda k: split_tree(jswin.init_swin(k, cfg_j))[0],
                          jax.random.PRNGKey(0))


def _jax_forward(cfg_j):
    return jax.jit(functools.partial(jswin.swin_forward, cfg=cfg_j,
                                     pcfg=JPCFG))


def _images(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.img_size, cfg.img_size, cfg.in_chans))
            .astype(np.float32),
            rng.integers(0, cfg.num_classes, size=b).astype(np.int32))


def _close(got, want, tol_rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_rel * scale)


def test_init_swin_has_the_jax_tree():
    """Same structure, leaf shapes and dtypes as the JAX init (the numbers
    differ: another generator); on the named device."""
    for cfg_j, cfg_t in CONFIGS.values():
        for dtype in ("float32", "bfloat16"):
            sj = _jax_shapes(dataclasses.replace(cfg_j, dtype=dtype))
            pt = tswin.init_swin(dataclasses.replace(cfg_t, dtype=dtype),
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
            assert jax.tree.structure(sj) == jax.tree.structure(
                tree_map(lambda t: 0, pt))
            lj, lt = jax.tree.leaves(sj), tree_leaves(pt)
            assert [tuple(a.shape) for a in lj] == [tuple(t.shape)
                                                    for t in lt]
            assert [str(a.dtype) for a in lj] == [str(t.dtype).split(".")[1]
                                                  for t in lt]
            assert all(t.device.type == "cpu" for t in lt)


@pytest.mark.parametrize("which", ["small", "base"])
def test_swin_forward_matches_jax(which):
    cfg_j, cfg_t = CONFIGS[which]
    pj = _params(cfg_t)
    imgs, _ = _images(cfg_j)
    lj, aj, zj = _jax_forward(cfg_j)(jax.tree.map(jnp.asarray, pj),
                                     jnp.asarray(imgs))
    pt = swin_params_from_jax(pj, cfg_t, device="cpu")
    lt, at, zt = tswin.swin_forward(pt, torch.from_numpy(imgs), cfg_t, TPCFG)
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg_t.num_classes)
    _close(lt, lj, 1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    np.testing.assert_allclose(float(zt), float(zj), rtol=1e-6)


def test_swin_forward_bf16_matches_jax():
    cfg_j, cfg_t = (dataclasses.replace(c, dtype="bfloat16")
                    for c in CONFIGS["small"])
    pj = _params(cfg_t, seed=2)
    # the JAX init's dtypes: bf16 matrices, f32 biases/norms/router/rel_bias
    pj = jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a, s.dtype)), pj,
                      _jax_shapes(cfg_j))
    imgs, _ = _images(cfg_j, seed=3)
    lj, _, _ = _jax_forward(cfg_j)(jax.tree.map(jnp.asarray, pj),
                                   jnp.asarray(imgs))
    pt = swin_params_from_jax(pj, cfg_t, device="cpu")
    assert pt["stages"][2]["blocks"][1]["moe"]["w1"].dtype == torch.bfloat16
    assert pt["stages"][2]["blocks"][1]["moe"]["b1"].dtype == torch.float32
    lt, _, _ = tswin.swin_forward(pt, torch.from_numpy(imgs), cfg_t, TPCFG)
    _close(lt, lj, 3e-2)


def test_layer_norm_uses_the_population_variance():
    """``jnp.var`` divides by n: torch's default (n - 1) would differ."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    p = {"scale": rng.normal(size=(8,)).astype(np.float32),
         "bias": rng.normal(size=(8,)).astype(np.float32)}
    want = np.asarray(jswin._ln(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                1e-5))
    got = tswin._ln({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), 1e-5)
    _close(got, want, 1e-6)
    xt = torch.from_numpy(x)
    sample_var = ((xt - xt.mean(-1, keepdim=True))
                  * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-5)
                  * torch.from_numpy(p["scale"]) + torch.from_numpy(p["bias"]))
    assert np.abs(sample_var.numpy() - want).max() > 1e-3


def test_gelu_is_the_tanh_form():
    """The dense MLP blocks and the experts use ``jax.nn.gelu``'s default
    tanh approximation; the erf form differs by up to ~5e-4 here."""
    pj = _params(tss.SMOKE_CONFIG, seed=5)
    m = pj["stages"][0]["blocks"][0]["mlp"]
    x = np.random.default_rng(6).normal(size=(4, m["w1"].shape[0])) * 3
    x = x.astype(np.float32)
    z = x @ m["w1"] + m["b1"]
    want = np.asarray(jax.nn.gelu(jnp.asarray(z)))
    got = tswin.ACTIVATIONS["gelu"](torch.from_numpy(z))
    _close(got, want, 1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(z))
    assert float((erf - got).abs().max()) > 1e-4


def test_shifted_window_rolls_without_a_mask_and_clamps(monkeypatch):
    """Block 1 of a stage rolls by window // 2 and attends without the
    cross-window mask, as the JAX model does; where the map is no larger
    than the window (stage 3's 7 x 7 map at 224^2 and window 7; here the
    smoke model's 1 x 1 last stage at window 2) the window shrinks to the
    map and nothing rolls. Checked on one attention sub-block against the
    JAX one, and on the whole forward by counting the rolls."""
    cfg_t = tss.SMOKE_CONFIG
    p_attn = _params(cfg_t, seed=7)["stages"][0]["blocks"][0]["attn"]
    x = np.random.default_rng(8).normal(size=(2, 8, 8, 16)).astype(np.float32)
    heads = cfg_t.heads[0]
    want = np.asarray(jnp.roll(jswin._window_attention(
        jax.tree.map(jnp.asarray, p_attn),
        jnp.roll(jnp.asarray(x), (-1, -1), axis=(1, 2)), heads, 2, 1e-5),
        (1, 1), axis=(1, 2)))
    pt = {k: torch.from_numpy(v) for k, v in p_attn.items()}
    got = torch.roll(tswin._window_attention(
        pt, torch.roll(torch.from_numpy(x), (-1, -1), dims=(1, 2)), heads,
        2), (1, 1), dims=(1, 2))
    _close(got, want, 1e-5)
    # a window larger than the map is clamped to it: one window
    x1 = torch.from_numpy(x[:, :2, :2])
    torch.testing.assert_close(tswin._window_attention(pt, x1, heads, 7),
                               tswin._window_attention(pt, x1, heads, 2))

    # two blocks a stage: block 1 rolls where the 8 x 8 and 4 x 4 maps
    # exceed the window of 2, not on the 2 x 2 and 1 x 1 maps
    cfg = dataclasses.replace(cfg_t, depths=(2, 2, 2, 2))
    rolls = []
    real_roll = torch.roll

    def spy(t, shifts, dims):
        rolls.append((tuple(t.shape[1:3]), shifts))
        return real_roll(t, shifts, dims)

    monkeypatch.setattr(torch, "roll", spy)
    tswin.swin_forward(tswin.init_swin(cfg, generator=torch.Generator(),
                                       device="cpu"),
                       torch.zeros((1, 32, 32, 3)), cfg, TPCFG)
    assert rolls == [((8, 8), (-1, -1)), ((8, 8), (1, 1)),
                     ((4, 4), (-1, -1)), ((4, 4), (1, 1))]


def test_window_attention_logits_in_f32_and_attn_cast_back():
    """bf16 activations: q k^T is taken in f32 (``preferred_element_type``)
    and ``attn`` is cast to bf16 before the product with v."""
    p_attn = _params(tss.SMOKE_CONFIG, seed=9)["stages"][1]["blocks"][0][
        "attn"]
    x = np.random.default_rng(10).normal(size=(2, 4, 4, 32))
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    pj = {k: jnp.asarray(v, jnp.float32 if k in ("rel_bias", "qkv_b",
                                                  "proj_b") else jnp.bfloat16)
          for k, v in p_attn.items()}
    want = jswin._window_attention(pj, jnp.asarray(xb, jnp.bfloat16), 2, 2,
                                   1e-5)
    pt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in pj.items()}
    got = tswin._window_attention(pt, torch.from_numpy(xb).bfloat16(), 2, 2)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), 2e-2)


def test_top1_gates_are_one_everywhere():
    """Swin-MoE routes top-1 with ``norm_topk``: every live gate is 1, so
    the expert outputs are unscaled and the router learns from the aux
    loss alone; the port keeps that rather than "fixing" it."""
    cfg = dataclasses.replace(
        tss.SMOKE_CONFIG, moe=dataclasses.replace(tss.SMOKE_CONFIG.moe,
                                                  top_k=1))
    params = tswin.init_swin(cfg, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    seen = []
    real = tops.esffn_mlp

    def spy(x, row_token, row_gate, *a, **kw):
        seen.append(row_gate[row_gate != 0])
        return real(x, row_token, row_gate, *a, **kw)

    tops.esffn_mlp = spy
    try:
        tswin.swin_forward(params, torch.randn((2, 32, 32, 3)), cfg, TPCFG)
    finally:
        tops.esffn_mlp = real
    assert len(seen) == 1 and all(torch.equal(g, torch.ones_like(g))
                                  for g in seen)


def test_patch_embedding_is_a_matmul_not_a_tf32_convolution(monkeypatch):
    """The stride-p patch convolution runs as one matmul over the patches,
    so cuDNN's default-on TF32 for convolutions never applies; f32
    matmuls stay in full f32 as torch defaults them."""
    def no_conv(*a, **kw):
        raise AssertionError("swin_forward called a convolution")

    monkeypatch.setattr(torch.nn.functional, "conv2d", no_conv)
    monkeypatch.setattr(torch, "conv2d", no_conv)
    cfg_j, cfg_t = CONFIGS["small"]
    pj = _params(cfg_t, seed=11)
    imgs, _ = _images(cfg_j, seed=12)
    lt, _, _ = tswin.swin_forward(swin_params_from_jax(pj, cfg_t,
                                                       device="cpu"),
                                  torch.from_numpy(imgs), cfg_t, TPCFG)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(imgs), jnp.asarray(pj["patch_w"]), (4, 4), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ps = cfg_t.patch_size
    got = torch.from_numpy(imgs).reshape(2, 8, ps, 8, ps, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(2, 8, 8, -1) @ torch.from_numpy(
        pj["patch_w"]).reshape(ps * ps * 3, -1)
    _close(got, ref, 1e-6)


def _jax_train_step(cfg_j, ocj):
    """``benchmarks/memory_table.py::make_train_fn``'s step."""
    def loss_fn(params, images, labels):
        logits, aux, _ = jswin.swin_forward(params, images, cfg_j, JPCFG,
                                            None)
        onehot = jax.nn.one_hot(labels, cfg_j.num_classes)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return ce + 0.01 * aux

    @jax.jit
    def step(params, opt, images, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, labels)
        params, opt, m = jadamw.apply_updates(params, grads, opt, ocj)
        return params, opt, loss, m

    return step


def test_train_steps_match_jax():
    """3 AdamW steps from the same weights, images and zero optimizer
    state: losses within 1e-5 relative, then one more step from the JAX
    state carried over by ``swin_opt_state_from_jax``."""
    cfg_j, cfg_t = CONFIGS["small"]
    ocj, oct_ = jadamw.OptimizerConfig(**OPT), tadamw.OptimizerConfig(**OPT)
    pj = jax.tree.map(jnp.asarray, _params(cfg_t, seed=13))
    pt = swin_params_from_jax(pj, cfg_t, device="cpu")
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    assert "master" not in oj and all(
        m is None for m in tree_leaves(ot.get("master", [None])))
    step_j = _jax_train_step(cfg_j, ocj)
    step_t = tswin.make_train_step(cfg_t, TPCFG, oct_)
    for step in range(4):
        imgs, labels = _images(cfg_j, b=4, seed=20 + step)
        if step == 3:       # carry the JAX state over and step both again
            nj = jax.tree.map(np.asarray, (pj, oj))
            pt = swin_params_from_jax(nj[0], cfg_t, device="cpu")
            ot = swin_opt_state_from_jax(nj[1], cfg_t, device="cpu")
            assert int(ot["step"]) == 3 and ot["step"].dtype == torch.int32
            for a, b in zip(tree_leaves(ot["m"]), jax.tree.leaves(nj[1]["m"])):
                np.testing.assert_array_equal(a.numpy(), b)
        pj, oj, lj, mj = step_j(pj, oj, jnp.asarray(imgs),
                                jnp.asarray(labels))
        pt, ot, mt = step_t(pt, ot, torch.from_numpy(imgs),
                            torch.from_numpy(labels))
        np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(mt["loss"]), float(mt["ce"] + 0.01 * mt["aux_loss"]),
            rtol=1e-6)


def test_unfused_backward_gives_the_fused_grads():
    """The paper's Fig. 12 ablation on the whole model: with
    ``set_fused_backward(False)`` every MoE block's (dW, db) pairs take
    ESTMM + ESS instead of ESFK, and the grads do not change."""
    cfg = tss.SMOKE_CONFIG
    params = tswin.init_swin(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")
    params = tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=torch.Generator().manual_seed(3)), params)
    imgs, labels = _images(cfg, seed=14)
    loss_fn = tswin.make_loss_fn(cfg, TPCFG)
    grads = {}
    for fused in (True, False):
        tops.set_fused_backward(fused)
        try:
            leaves = [t.detach().clone().requires_grad_()
                      for t in tree_leaves(params)]
            it = iter(leaves)
            tree = tree_map(lambda _: next(it), params)
            total, _ = loss_fn(tree, torch.from_numpy(imgs),
                               torch.from_numpy(labels))
            grads[fused] = torch.autograd.grad(total, leaves)
        finally:
            tops.set_fused_backward(True)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_entry_points_default_to_the_gpu_and_refuse_what_is_not_ported(
        monkeypatch):
    cfg = tss.SMOKE_CONFIG
    params = tswin.init_swin(cfg, generator=torch.Generator(), device="cpu")
    x = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="moe_impl 'deepspeed'"):
        tswin.swin_forward(params, x, cfg, TPCFG, moe_impl="deepspeed")
    with pytest.raises(NotImplementedError, match="mesh"):
        tswin.swin_forward(params, x, cfg, TPCFG, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tswin.init_swin(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tswin.synthetic_batch(cfg, 2, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swin_params_from_jax(_params(cfg), cfg)
    imgs, labels = tswin.synthetic_batch(
        cfg, 3, generator=torch.Generator().manual_seed(0), device="cpu")
    assert imgs.shape == (3, 32, 32, 3) and labels.shape == (3,)
    assert int(labels.max()) < cfg.num_classes
