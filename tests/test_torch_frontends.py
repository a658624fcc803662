"""PyTorch port vs the JAX package: the frontend families.

paligemma-3b (SigLIP patch projection before the token embeddings, the
bidirectional prefix-LM mask, the tied 257k-entry head at full size,
here its smoke config) and musicgen-large (EnCodec frame projection, T5
cross-attention after every attention mixer, 4 codebook heads), on their
f32 smoke configs, from the same weights (``params_from_jax``):

* 2 AdamW steps of the port's ``make_train_step`` against the JAX one
  (``impl="pallas"`` in interpret mode, blk 8) on the batches the train
  CLIs build (``train.frontend_batch``, checked against the JAX
  trainer's construction): losses within 1e-5 relative, the grad norm
  within 1e-4;
* the dense ``make_prefill_step`` (paligemma: patches + tokens; musicgen:
  frames + conditioning) and 2 ``make_serve_step`` decodes after it
  (paligemma: tokens; musicgen: frames + conditioning): logits and every
  cache leaf within 1e-5 x max(1, max|ref|), the lengths equal;
* the prefix mask: a later prefix row moves an earlier row's hidden
  state, a text row moves none before it;
* ``params_from_jax``/``opt_state_from_jax`` carry ``frontend.proj``,
  ``cb_heads``, ``ln_x`` and ``xattn`` across;
* the train CLI runs xlstm-350m, musicgen-large and paligemma-3b
  (``--smoke --device cpu``) with finite losses;
* the serving engines, ``reference_stream`` and the serve CLI refuse
  musicgen-large (EnCodec frames, codebook heads) with a
  ``NotImplementedError``, as no JAX engine serves it, and take
  paligemma-3b's token prompts (held to the JAX engines in
  ``test_torch_graft_paligemma.py``), and the MLP-experts graft.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.common import tree_leaves
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

ARCHS = ["paligemma-3b", "musicgen-large"]
BATCH, SEQ, STEPS = 2, 32, 2
OPT = dict(peak_lr=3e-4, warmup_steps=2, decay_steps=6)
JPCFG, TPCFG = JPC(blk=8, impl="pallas"), TPC(blk=8)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX config, port config, JAX params) of the f32 smoke config."""
    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32")
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32")
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj


def _port_params(arch, pj=None):
    cfg_j, cfg_t, p0 = _models(arch)
    return params_from_jax(jax.tree.map(np.asarray, p0 if pj is None else pj),
                           cfg_t, device="cpu")


def _jax_cli_batch(cfg, batch, step):
    """``repro.launch.train``'s frontend batch (its step_fn), in numpy."""
    rngb = np.random.default_rng(step)
    b, s = batch["tokens"].shape
    if cfg.frontend == "encodec":
        return {
            "embeds": np.asarray(jnp.asarray(
                rngb.normal(size=(b, s, cfg.frontend_dim)), jnp.float32)),
            "cond": np.asarray(jnp.asarray(
                rngb.normal(size=(b, 64, cfg.cross_d)), jnp.float32)),
            "labels": np.asarray(jnp.repeat(
                batch["labels"][..., None], cfg.num_codebooks, -1)),
            "loss_mask": batch["loss_mask"]}
    npatch = cfg.prefix_len
    return {
        "patches": np.asarray(jnp.asarray(
            rngb.normal(size=(b, npatch, cfg.frontend_dim)), jnp.float32)),
        "tokens": batch["tokens"][:, : s - npatch],
        "labels": batch["labels"], "loss_mask": batch["loss_mask"]}


def _close(got, want, what, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    cfg_j, cfg_t, pj = _models(arch)
    pt = _port_params(arch)
    ocj, oct_ = jadamw.OptimizerConfig(**OPT), tadamw.OptimizerConfig(**OPT)
    step_j = jax.jit(jsteps.make_train_step(cfg_j, JPCFG, None, ocj,
                                            (BATCH, SEQ, cfg_j.d_model)))
    step_t = tsteps.make_train_step(cfg_t, TPCFG, oct_)
    src = TokenSource(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab_size=cfg_t.vocab_size, seed=1))
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    for step in range(STEPS):
        tb = ttrain.frontend_batch(cfg_t, src.batch(step), step)
        jb = _jax_cli_batch(cfg_j, src.batch(step), step)
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k])
        pj, oj, mj = step_j(pj, oj, {k: jnp.asarray(v) for k, v in jb.items()})
        pt, ot, mt = step_t(pt, ot, ttrain.batch_to(tb, "cpu"))
        for key in ("loss", "total_loss", "aux_loss", "z_loss"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{arch} step {step} {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
    # embed is unused by the encodec forward: its grad is 0 in both, and
    # weight decay alone moves it
    if cfg_t.frontend == "encodec":
        np.testing.assert_allclose(ot["m"]["embed"].numpy(), 0.0)


def _dense_inputs(cfg, rng, s, decode=False):
    """Prefill (or, ``decode``, one-token) inputs of ``cfg`` for BATCH
    rows, as numpy arrays."""
    if cfg.frontend == "encodec":
        return {"embeds": rng.normal(size=(BATCH, 1 if decode else s,
                                           cfg.frontend_dim)).astype(
                                               np.float32),
                "cond": rng.normal(size=(BATCH, 8, cfg.cross_d)).astype(
                    np.float32)}
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, 1 if decode else s)
                          ).astype(np.int32)
    if decode:
        return {"tokens": tokens}
    return {"patches": rng.normal(size=(BATCH, cfg.prefix_len,
                                        cfg.frontend_dim)).astype(np.float32),
            "tokens": tokens}


def _assert_cache_close(tc, jc, cfg_t):
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        assert sorted(layer) == sorted(jc["layers"][pos])
        for name, t in layer.items():
            _close(t, np.asarray(jc["layers"][pos][name][j]),
                   f"layer {li} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    cfg_j, cfg_t, pj = _models(arch)
    pt = _port_params(arch)
    rng = np.random.default_rng(5)
    s = 5
    inp = _dense_inputs(cfg_t, rng, s)
    total = s + (cfg_t.prefix_len if "patches" in inp else 0)
    max_seq = 24
    jl, jc = jsteps.make_prefill_step(cfg_j, JPCFG, None,
                                      (BATCH, total, cfg_j.d_model))(
        pj, {k: jnp.asarray(v) for k, v in inp.items()},
        jlm.init_cache(cfg_j, BATCH, max_seq))
    tl, tc = tsteps.make_prefill_step(cfg_t, TPCFG)(
        pt, {k: torch.from_numpy(v) for k, v in inp.items()},
        tlm.init_cache(cfg_t, BATCH, max_seq, "cpu"))
    want_shape = (BATCH, 1) + ((cfg_t.num_codebooks,)
                               if cfg_t.num_codebooks > 1 else ()) + (
        cfg_t.vocab_size,)
    assert tuple(tl.shape) == want_shape
    _close(tl, jl, f"{arch} prefill logits")
    _assert_cache_close(tc, jc, cfg_t)
    assert tc["len"].tolist() == [total] * BATCH
    jstep = jsteps.make_serve_step(cfg_j, JPCFG, None, (BATCH, 1, cfg_j.d_model))
    tstep = tsteps.make_serve_step(cfg_t, TPCFG)
    for t in range(2):
        d = _dense_inputs(cfg_t, rng, 1, decode=True)
        jl, jc = jstep(pj, {k: jnp.asarray(v) for k, v in d.items()}, jc)
        tl, tc = tstep(pt, {k: torch.from_numpy(v) for k, v in d.items()}, tc)
        assert tuple(tl.shape) == want_shape
        _close(tl, jl, f"{arch} decode {t} logits")
        _assert_cache_close(tc, jc, cfg_t)
    assert tc["len"].tolist() == [total + 2] * BATCH


def test_prefix_mask_is_bidirectional():
    """paligemma's prefix rows see each other in both directions; text
    rows see only what is before them."""
    _, cfg_t, _ = _models("paligemma-3b")
    pt = _port_params("paligemma-3b")
    inp = {k: torch.from_numpy(v) for k, v in _dense_inputs(
        cfg_t, np.random.default_rng(6), 6).items()}
    npx = cfg_t.prefix_len

    def hidden(x):
        h, _, _, _ = tlm.forward(pt, x, cfg_t, TPCFG, mode="train",
                                 return_hidden=True)
        return h

    base = hidden(inp)
    later_patch = dict(inp, patches=inp["patches"].clone())
    later_patch["patches"][:, npx - 1] += 1.0
    moved = (hidden(later_patch) - base).abs().amax(dim=(0, 2))
    assert (moved[:npx] > 0).all()              # every prefix row sees it
    later_tok = dict(inp, tokens=inp["tokens"].clone())
    later_tok["tokens"][:, 2] = (later_tok["tokens"][:, 2] + 1) % \
        cfg_t.vocab_size
    moved = (hidden(later_tok) - base).abs().amax(dim=(0, 2))
    assert (moved[:npx + 2] == 0).all() and (moved[npx + 2:] > 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_new_leaves(arch):
    cfg_j, cfg_t, pj = _models(arch)
    pt = _port_params(arch)
    if cfg_t.frontend:
        np.testing.assert_array_equal(pt["frontend"]["proj"].numpy(),
                                      np.asarray(pj["frontend"]["proj"]))
    names = []
    if cfg_t.num_codebooks > 1:
        np.testing.assert_array_equal(pt["cb_heads"].numpy(),
                                      np.asarray(pj["cb_heads"]))
        names = ["ln_x", "xattn"]
    for li, layer in enumerate(pt["layers"]):
        j, pos = divmod(li, cfg_t.period)
        for name in names:
            for a, b in zip(tree_leaves(layer[name]),
                            jax.tree.leaves(pj["layers"][pos][name])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b)[j])
    # the optimizer state of a JAX step carries the same leaves
    ocj = jadamw.OptimizerConfig(**OPT)
    oj = jadamw.init_opt_state(pj, ocj)
    src = TokenSource(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab_size=cfg_t.vocab_size, seed=2))
    jb = {k: jnp.asarray(v) for k, v in _jax_cli_batch(
        cfg_j, src.batch(0), 0).items()}
    _, oj, _ = jax.jit(jsteps.make_train_step(
        cfg_j, JPC(blk=8, impl="blocked"), None, ocj,
        (BATCH, SEQ, cfg_j.d_model)))(pj, oj, jb)
    nj = jax.tree.map(np.asarray, oj)
    ot = opt_state_from_jax(nj, cfg_t, device="cpu")
    for key in ("m", "v"):
        for a, b in zip(tree_leaves({k: v for k, v in ot[key].items()
                                     if k != "layers"}),
                        jax.tree.leaves({k: v for k, v in nj[key].items()
                                         if k != "layers"})):
            np.testing.assert_array_equal(a.numpy(), b)
        for li, layer in enumerate(ot[key]["layers"]):
            j, pos = divmod(li, cfg_t.period)
            jl = jax.tree.leaves(nj[key]["layers"][pos])
            tl = tree_leaves(layer)
            assert len(tl) == len(jl)
            for a, b in zip(tl, jl):
                np.testing.assert_array_equal(a.numpy(), b[j])


@pytest.mark.parametrize("arch", ["xlstm-350m", "musicgen-large",
                                  "paligemma-3b"])
def test_train_cli_runs(arch, capsys):
    log = ttrain.main(["--arch", arch, "--smoke", "--steps", "2",
                       "--global-batch", "2", "--seq-len", "32",
                       "--device", "cpu"])
    assert [m["step"] for m in log] == [1, 2]
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in log)
    assert "[train] finished at step 2" in capsys.readouterr().out


def test_serving_refuses_frontends_and_codebooks():
    """musicgen-large stays refused on every serving entry point; paligemma
    serves its token prompts on each, and so does the MLP-experts graft."""
    for arch in ARCHS:
        _, cfg_t, _ = _models(arch)
        pt = _port_params(arch)
        makers = (
            lambda: tserve.BatchedServer(cfg_t, TPCFG, num_slots=2,
                                         max_seq=16, params=pt,
                                         device="cpu"),
            lambda: tserve.PagedServer(cfg_t, TPCFG, num_slots=2,
                                       page_size=4, num_pages=9,
                                       max_pages_per_slot=4, params=pt,
                                       device="cpu"),
            lambda: tserve.reference_stream(
                cfg_t, TPCFG, pt, tserve.Request(
                    rid=0, prompt=np.array([1, 2], np.int32), max_new=2),
                max_seq=16),
            lambda: tserve.main(["--arch", arch, "--smoke", "--device",
                                 "cpu", "--requests", "2", "--max-new",
                                 "2", "--max-seq", "16"]))
        for make in makers:
            if arch == "musicgen-large":
                with pytest.raises(NotImplementedError,
                                   match="token prompts and one"):
                    make()
            else:
                with torch.no_grad():
                    assert make() is not None
    graft = dataclasses.replace(tcfglib.get_smoke_config("qwen3-moe-30b-a3b"),
                                glu=False)
    tlm.check_servable(graft)
