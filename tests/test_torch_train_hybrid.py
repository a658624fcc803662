"""PyTorch port vs the JAX package: training the stacks with recurrent
mixers.

* the whole train step: 2 AdamW steps of the port's ``make_train_step``
  against the JAX ``make_train_step`` (mesh None, ``impl="pallas"`` in
  interpret mode, blk 8) on the f32 smoke configs of jamba-1.5-large-398b
  (Mamba + attention, MoE and dense GLU FFNs) and xlstm-350m (mLSTM and
  sLSTM), from the same weights (``params_from_jax``), batches and zero
  optimizer state: losses within 1e-5 relative, the grad norm within
  1e-4 (the dense decoders: ``test_torch_train_dense.py``; the layers'
  grads alone: ``test_torch_recurrent_grads.py``);
* the AdamW state of both stacks carries over (``opt_state_from_jax``:
  the moments of Mamba, mLSTM, sLSTM, MoE and dense-FFN leaves, in layer
  order) and the next step agrees;
* the widths at which one card trains Jamba's period
  (``configs/jamba_1_5_large_398b.py::cut_config``) give JAX's
  parameter counts of the same cut, leaf for leaf.

The jitted JAX steps are built once a config (``_steps``).
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
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

ARCHS = ["jamba-1.5-large-398b", "xlstm-350m"]
BATCH, SEQ, STEPS = 2, 32, 2
OPT = dict(peak_lr=3e-4, warmup_steps=2, decay_steps=6)


@functools.lru_cache(maxsize=None)
def _steps(arch):
    """(port config, JAX initial params, optimizer configs, jitted JAX
    step, port step, token source) of ``arch``'s f32 smoke config."""
    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32")
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32")
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    ocj, oct_ = jadamw.OptimizerConfig(**OPT), tadamw.OptimizerConfig(**OPT)
    step_j = jax.jit(jsteps.make_train_step(
        cfg_j, JPC(blk=8, impl="pallas"), None, ocj,
        (BATCH, SEQ, cfg_j.d_model)))
    step_t = tsteps.make_train_step(cfg_t, TPC(blk=8), oct_)
    src = TokenSource(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab_size=cfg_t.vocab_size, seed=1))
    return cfg_t, pj, ocj, oct_, step_j, step_t, src


def _setup(arch):
    """``_steps`` and a fresh port copy of the initial params (the port's
    step updates its params in place)."""
    cfg_t, pj, ocj, oct_, step_j, step_t, src = _steps(arch)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_t, pj, pt, ocj, oct_, step_j, step_t, src


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    check_steps(arch)


def check_steps(arch):
    """2 steps of both packages from the same state and batches."""
    _, pj, pt, ocj, oct_, step_j, step_t, src = _setup(arch)
    oj, ot = jadamw.init_opt_state(pj, ocj), tadamw.init_opt_state(pt, oct_)
    for step in range(STEPS):
        b = src.batch(step)
        pj, oj, mj = step_j(pj, oj, {k: jnp.asarray(v) for k, v in b.items()})
        pt, ot, mt = step_t(pt, ot, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        for key in ("loss", "total_loss", "aux_loss", "z_loss"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{arch} step {step} {key}")
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
    assert int(ot["step"]) == STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_opt_state_carries_over(arch):
    """One JAX step; the port's AdamW state from it equals JAX's leaf for
    leaf in layer order (masters of the f32 stack are None), and the next
    steps agree."""
    cfg_t, pj, _, ocj, _, step_j, step_t, src = _setup(arch)
    oj = jadamw.init_opt_state(pj, ocj)
    b = {k: jnp.asarray(v) for k, v in src.batch(0).items()}
    pj, oj, _ = step_j(pj, oj, b)
    nj = jax.tree.map(np.asarray, (pj, oj))
    pt = params_from_jax(nj[0], cfg_t, device="cpu")
    ot = opt_state_from_jax(nj[1], cfg_t, device="cpu")
    assert int(ot["step"]) == 1
    for key in ("m", "v"):
        for li, layer in enumerate(ot[key]["layers"]):
            pp, pos = divmod(li, cfg_t.period)
            jl = jax.tree.leaves(nj[1][key]["layers"][pos])
            tl = tree_leaves(layer)
            assert len(tl) == len(jl) > 0
            for a, w in zip(tl, jl):
                np.testing.assert_array_equal(a.numpy(), w[pp])
    assert all(m is None for m in tree_leaves(ot["master"]))
    bt = {k: torch.from_numpy(v) for k, v in src.batch(1).items()}
    pj, oj, mj = step_j(pj, oj, {k: jnp.asarray(v)
                                 for k, v in src.batch(1).items()})
    pt, ot, mt = step_t(pt, ot, bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("width", ["reference", "train"])
def test_jamba_cut_widths_are_jax_shapes(width):
    """``cut_config`` (the widths at which one card trains Jamba's period)
    builds, leaf for leaf, as many elements as JAX's ``abstract_params``
    gives the same cut of the JAX config (JAX keeps a leading axis of 1
    on some leaves, which ``params_from_jax`` drops): 0.89 B and 3.02 B
    parameters."""
    from repro_torch.configs import jamba_1_5_large_398b as tjamba
    from repro_torch.models import lm as tlm

    w = tjamba.CUT_WIDTHS[width]
    jcfg = jcfglib.get_config("jamba-1.5-large-398b")
    jcfg = dataclasses.replace(
        jcfg, num_layers=len(jcfg.layer_pattern), d_model=w["d_model"],
        num_heads=w["heads"], num_kv_heads=w["kv_heads"], d_ff=w["ffn"],
        moe=dataclasses.replace(jcfg.moe, d_ff=w["ffn"]),
        mamba=dataclasses.replace(jcfg.mamba,
                                  expand=w["d_inner"] // w["d_model"],
                                  dt_rank=w["dt_rank"]), dtype="bfloat16")
    want = [int(np.prod(s.shape)) for s in
            jax.tree_util.tree_leaves(jlm.abstract_params(jcfg)[0])]
    got = [t.numel() for t in tree_leaves(tlm.init_params(
        tjamba.cut_config(width, "bfloat16"), generator=None,
        device="meta"))]
    assert got == want
    n = sum(got)
    assert n == {"reference": 890_935_296, "train": 3_023_384_576}[width]
