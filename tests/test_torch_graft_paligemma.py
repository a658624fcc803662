"""PyTorch port vs the JAX package: MLP experts in an LM stack, and
paligemma-3b's token prompts on the serving engines.

* The graft: qwen3-moe-30b-a3b's f32 smoke config with ``glu=False``
  (``dataclasses.replace`` in both packages; no shipped configuration
  uses it), whose MoE FFNs run ``moe_mlp`` (``w1``/``b1``/``w2``/``b2``
  experts, ``esffn_mlp`` on the card). From the same weights
  (``params_from_jax``, which carries the expert biases in JAX's
  layout): 2 AdamW steps of the train step against JAX's (losses within
  1e-5 relative, the grad norm within 1e-4, as
  ``test_torch_train_hybrid.check_steps`` holds the other stacks), and
  ``BatchedServer``, ``PagedServer`` (streams and the whole ``trace``)
  and ``reference_stream`` against the JAX engines, greedy and sampled.
  The port's own init draws the biases as f32 zeros of JAX's shapes, and
  ``quant="int8"`` quantizes ``w1``/``w2`` as JAX's ``quantize_ffn``
  does.
* paligemma-3b's f32 smoke config: the engines take its token prompts
  (no SigLIP patches: the token embeddings, as JAX's ``_embed_in`` takes
  them), streams and traces equal to JAX's engines'.

The JAX side runs ``ParallelConfig(blk=8, impl="pallas")``, its Pallas
kernels in interpret mode. The same on a (2, 2) mesh:
``test_torch_mesh_paged.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro.quant import quantize_lm_params
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

GRAFT, PALI = "graft", "paligemma-3b"
JPCFG, TPCFG = JPC(blk=8, impl="pallas"), TPC(blk=8)
BATCH, SEQ, STEPS = 2, 32, 2
OPT = dict(peak_lr=3e-4, warmup_steps=2, decay_steps=6)
SLOTS, MAX_SEQ, PAGE, CHUNK = 3, 32, 4, 5


def _cfgs(name):
    arch = "qwen3-moe-30b-a3b" if name == GRAFT else name
    extra = {"glu": False} if name == GRAFT else {}
    return tuple(dataclasses.replace(pkg.get_smoke_config(arch),
                                     dtype="float32", **extra)
                 for pkg in (jcfglib, tcfglib))


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg_j, cfg_t = _cfgs(name)
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj


def _port_params(name):
    _, cfg_t, pj = _models(name)
    return params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")


def _requests(vocab, temperature):
    rng = np.random.default_rng(21)
    return [dict(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(2, 11))).astype(np.int32),
        max_new=int(rng.integers(2, 6)),
        temperature=temperature if i % 2 else 0.0, seed=i)
        for i in range(6)]


def _serve(pkg, name, engine, reqs):
    cfg_j, cfg_t, pj = _models(name)
    if pkg == "jax":
        srv_mod, cfg, params, pc = jserve, cfg_j, pj, JPCFG
        args, kw = (cfg, pc, None), {}
    else:
        srv_mod, cfg, params, pc = tserve, cfg_t, _port_params(name), TPCFG
        args, kw = (cfg, pc), {"device": "cpu"}
    if engine == "paged":
        maxp = MAX_SEQ // PAGE
        srv = srv_mod.PagedServer(*args, num_slots=SLOTS, page_size=PAGE,
                                  num_pages=1 + SLOTS * maxp,
                                  max_pages_per_slot=maxp, params=params,
                                  prefill_chunk=CHUNK, **kw)
    else:
        srv = srv_mod.BatchedServer(*args, num_slots=SLOTS, max_seq=MAX_SEQ,
                                    params=params, **kw)
    for r in reqs:
        srv.submit(srv_mod.Request(**r))
    with torch.no_grad():
        done = srv.run()
    return srv, {r.rid: list(r.out) for r in done}


# ---------------------------------------------------------------------------
# the graft's train step
# ---------------------------------------------------------------------------

def test_graft_params_carry_the_expert_biases():
    """JAX's MLP-expert leaves carry over as they are laid out, and the
    port's own init draws the same shapes (biases f32 zeros)."""
    _, cfg_t, pj = _models(GRAFT)
    pt = _port_params(GRAFT)
    own = tlm.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    for li in range(cfg_t.num_layers):
        ffn_j = pj["layers"][0]["ffn"]
        ffn_t, ffn_o = pt["layers"][li]["ffn"], own["layers"][li]["ffn"]
        assert sorted(ffn_t) == sorted(ffn_j) == sorted(ffn_o) == \
            ["b1", "b2", "router", "w1", "w2"]
        for k, v in ffn_j.items():
            np.testing.assert_array_equal(ffn_t[k].numpy(),
                                          np.asarray(v)[li])
            assert tuple(ffn_o[k].shape) == tuple(ffn_t[k].shape)
        assert ffn_o["b1"].dtype == ffn_o["b2"].dtype == torch.float32
        assert not ffn_o["b1"].any() and not ffn_o["b2"].any()


def test_graft_int8_init_quantizes_the_mlp_experts_as_jax():
    """``init_params(quant="int8")`` of the graft: ``w1``/``w2`` payloads
    and scales equal to JAX's ``quantize_lm_params`` of the same draw,
    the router and biases as drawn."""
    _, cfg_t, _ = _models(GRAFT)
    plain = tlm.init_params(cfg_t, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    q = tlm.init_params(cfg_t, generator=torch.Generator().manual_seed(3),
                        device="cpu", quant="int8")
    cfg_j, _, _ = _models(GRAFT)
    stacked = {"layers": [{"ffn": {k: np.stack([
        plain["layers"][li]["ffn"][k].numpy()
        for li in range(cfg_t.num_layers)]) for k in plain["layers"][0]["ffn"]
    }}]}
    want = quantize_lm_params(stacked, cfg_j, mode="int8")["layers"][0]["ffn"]
    for li in range(cfg_t.num_layers):
        got = q["layers"][li]["ffn"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v)[li],
                                          err_msg=k)


def test_graft_train_steps_match_jax():
    cfg_j, cfg_t, pj = _models(GRAFT)
    ocj, oct_ = jadamw.OptimizerConfig(**OPT), tadamw.OptimizerConfig(**OPT)
    step_j = jax.jit(jsteps.make_train_step(cfg_j, JPCFG, None, ocj,
                                            (BATCH, SEQ, cfg_j.d_model)))
    step_t = tsteps.make_train_step(cfg_t, TPCFG, oct_)
    src = TokenSource(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab_size=cfg_t.vocab_size, seed=1))
    pt = _port_params(GRAFT)
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    for step in range(STEPS):
        b = src.batch(step)
        pj, oj, mj = step_j(pj, oj, {k: jnp.asarray(v) for k, v in b.items()})
        pt, ot, mt = step_t(pt, ot, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        for key in ("loss", "total_loss", "aux_loss", "z_loss"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
    # the expert biases moved, and as JAX's did (an element whose
    # gradient is near 0 takes Adam's normalized step from rounding noise:
    # the absolute limit, 1e-5 of the largest bias)
    for li in range(cfg_t.num_layers):
        for k in ("b1", "b2"):
            got = pt["layers"][li]["ffn"][k].detach().numpy()
            want = np.asarray(pj["layers"][0]["ffn"][k])[li]
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=1e-3,
                                       atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# both engines: the graft and paligemma's token prompts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("name", [GRAFT, PALI])
def test_engines_match_jax(name, engine):
    _, cfg_t, _ = _models(name)
    reqs = _requests(cfg_t.vocab_size, temperature=0.8)
    jsrv, jout = _serve("jax", name, engine, reqs)
    tsrv, tout = _serve("torch", name, engine, reqs)
    assert len(tout) == len(reqs)
    assert tout == jout
    if engine == "paged":
        assert tsrv.trace == jsrv.trace
        assert tsrv.stats() == jsrv.stats()
        tsrv.pool.assert_consistent()


@pytest.mark.parametrize("name", [GRAFT, PALI])
def test_reference_stream_matches_the_engines(name):
    """The batch-1 ``reference_stream`` gives the paged engine's greedy
    streams."""
    _, cfg_t, _ = _models(name)
    reqs = _requests(cfg_t.vocab_size, temperature=0.0)[:3]
    _, out = _serve("torch", name, "paged", reqs)
    pt = _port_params(name)
    step = tsteps.make_serve_step(cfg_t, TPCFG)
    with torch.no_grad():
        refs = {r["rid"]: tserve.reference_stream(
            cfg_t, TPCFG, pt, tserve.Request(**r), max_seq=MAX_SEQ,
            step=step) for r in reqs}
    assert refs == out
