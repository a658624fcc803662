"""PyTorch port vs the JAX package: quantization-aware training.

On the CPU, from the same numpy inputs and weights (the LM's carried over
by ``params_from_jax``, Swin's by ``swin_params_from_jax``), the JAX side
as its own tests run it (Pallas in interpret mode, blk 8):

* ``fake_quant``: the forward bit for bit against JAX's (int8 and fp8,
  f32 and bf16 weights) and the straight-through gradient, exactly the
  cotangent;
* stochastic rounding, ``quantize_blockwise(rng=key)``: payloads and
  scales bit for bit against ``quantize_blockwise(rng=PRNGKey(s))`` for
  several seeds and shapes (``u`` is ``jax.random.uniform(key,
  w.shape)``'s bits over the flat positions); fp8 refuses it;
* ``ParallelConfig.quant`` and ``quant_tile``, validated;
* the MoE layer with ``quant="int8"``: output, aux and z, and the grads
  of x, the router and the three expert weights against ``jax.grad``;
* one LM train step (qwen3-moe smoke, f32, int8) and one Swin-MoE train
  step (its smoke config, f32, fp8): loss and every grad leaf;
* the train CLI's ``--quant int8`` on the CPU.

Tolerances, as ``test_torch_train.py``'s: f32 outputs and grads at 1e-5
x max|ref| (summation order only: the round trip itself is bit for bit,
so no quantization level differs between the packages on equal weights);
losses at 1e-5 relative, aux and z at 1e-6. Only the first step is held
to JAX: an AdamW update that differs by an ulp moves some weight across
a rounding boundary, after which the two round trips differ by a level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.configs import swin_moe_small as jss
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import swin as jswin
from repro.parallel import moe_parallel as jmp
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro.quant import core as jq
from repro_torch import configs as tcfglib
from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs import swin_moe_small as tss
from repro_torch.convert import params_from_jax, swin_params_from_jax
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import sampling
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import swin as tswin
from repro_torch.parallel import moe_parallel as tmp
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.quant import core as tq

torch.set_num_threads(1)

OUT_TOL = 1e-5      # x max|ref|, f32 outputs and grads
LOSS_RTOL = 1e-5
AUX_RTOL = 1e-6


def _close(got, want, tol_rel=OUT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_rel * scale)


def _tiled(rng, shape, tile):
    """Weights whose (tile x tile) blocks differ in magnitude, so a wrong
    scale grid would show."""
    w = rng.normal(size=shape).astype(np.float32)
    na, nb = shape[-2] // tile, shape[-1] // tile
    mag = np.exp(rng.normal(size=shape[:-2] + (na, 1, nb, 1)))
    w = w.reshape(shape[:-2] + (na, tile, nb, tile)) * mag
    return w.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# fake_quant and stochastic rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_jax_and_passes_grads_straight(mode, dtype):
    rng = np.random.default_rng(3)
    w = _tiled(rng, (3, 32, 48), 16)
    ct = rng.normal(size=w.shape).astype(np.float32)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want = np.asarray(jq.fake_quant(jw, mode, 16).astype(jnp.float32))
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
    got = tq.fake_quant(tw, mode, 16)
    assert got.dtype == tw.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    tct = torch.from_numpy(ct).to(tw.dtype)
    (got * tct).sum().backward()
    assert torch.equal(tw.grad, tct)
    jgrad = jax.grad(lambda v: jnp.sum(
        jq.fake_quant(v, mode, 16) * jnp.asarray(ct, jw.dtype)))(jw)
    np.testing.assert_array_equal(tw.grad.float().numpy(),
                                  np.asarray(jgrad.astype(jnp.float32)))


@pytest.mark.parametrize("seed,shape,tile", [
    (0, (3, 32, 48), 16), (7, (2, 8, 12), 4), (2 ** 31 + 5, (1, 64, 128), 128),
    (12345, (4, 16, 40), 8)])
def test_stochastic_rounding_is_jax_bit_for_bit(seed, shape, tile):
    w = _tiled(np.random.default_rng(seed % 1000), shape, min(tile, 4))
    jqv, js = jq.quantize_blockwise(jnp.asarray(w), mode="int8", tile=tile,
                                    rng=jax.random.PRNGKey(seed))
    tqv, ts = tq.quantize_blockwise(torch.from_numpy(w), mode="int8",
                                    tile=tile, rng=sampling.prng_key(seed))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # stochastic: some levels differ from round-to-nearest's
    near, _ = tq.quantize_blockwise(torch.from_numpy(w), mode="int8",
                                    tile=tile)
    assert (near != tqv).any()
    assert ((near.int() - tqv.int()).abs() <= 1).all()


def test_stochastic_rounding_is_int8_only():
    w = torch.ones(1, 4, 4)
    with pytest.raises(ValueError, match="int8-only"):
        tq.quantize_blockwise(w, mode="fp8", rng=sampling.prng_key(0))
    with pytest.raises(ValueError, match="int8-only"):
        jq.quantize_blockwise(jnp.ones((1, 4, 4)), mode="fp8",
                              rng=jax.random.PRNGKey(0))


def test_parallel_config_validates_quant():
    assert TPC().quant == "none" and TPC().quant_tile == 128
    assert TPC(quant="fp8", quant_tile=64).quant == "fp8"
    with pytest.raises(ValueError, match="quant"):
        TPC(quant="int4")
    with pytest.raises(ValueError, match="quant_tile"):
        TPC(quant="int8", quant_tile=0)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

D, F, E, K = 16, 32, 4, 2


def test_moe_layer_qat_matches_jax():
    """The island fake-quantizes the expert weights (tile 8: 2 x 4 blocks
    an expert), never the router: output, aux, z and every grad."""
    rng = np.random.default_rng(11)
    w = {"router": rng.normal(size=(D, E)).astype(np.float32),
         "w_gate": _tiled(rng, (E, D, F), 8) * 0.3,
         "w_up": _tiled(rng, (E, D, F), 8) * 0.3,
         "w_down": _tiled(rng, (E, F, D), 8) * 0.3}
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    ms = dict(num_experts=E, top_k=K, act="silu", glu=True)
    names = ("router", "w_gate", "w_up", "w_down")

    def jloss(x_, *ws):
        y, aux, z = jmp.moe_layer(
            x_, jmp.MoEParams(**dict(zip(names, ws))), jmp.MoEStatic(**ms),
            JPC(blk=8, impl="pallas", mode="hybrid", quant="int8",
                quant_tile=8), None, x_spec=None)
        return jnp.sum(y * ct) + aux + z, (y, aux, z)

    (_, (jy, jaux, jz)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in names))
    tx = torch.from_numpy(x).requires_grad_()
    tw = {k: torch.from_numpy(w[k]).requires_grad_() for k in names}
    ty, taux, tz = tmp.moe_layer(tx, tw, tmp.MoEStatic(**ms),
                                 TPC(blk=8, quant="int8", quant_tile=8))
    ((ty * torch.from_numpy(ct)).sum() + taux + tz).backward()
    _close(ty, jy)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=AUX_RTOL)
    np.testing.assert_allclose(float(tz.detach()), float(jz), rtol=AUX_RTOL)
    for t, g in zip([tx] + [tw[k] for k in names], jg):
        _close(t.grad, g)
    # the quantized forward differs from the full-precision one
    plain, _, _ = tmp.moe_layer(tx, tw, tmp.MoEStatic(**ms), TPC(blk=8))
    assert not torch.allclose(plain, ty, rtol=0, atol=1e-6)


def test_moe_layer_skips_fake_quant_of_true_quantized_weights():
    """Params that already hold 8-bit payloads and scales go to the 8-bit
    path untouched, as JAX's ``maybe_fq`` leaves them."""
    rng = np.random.default_rng(12)
    w = {"router": torch.from_numpy(rng.normal(size=(D, E)).astype(
        np.float32)), **{k: torch.from_numpy(_tiled(rng, s, 8))
                         for k, s in (("w_gate", (E, D, F)),
                                      ("w_up", (E, D, F)),
                                      ("w_down", (E, F, D)))}}
    qw = tq.quantize_ffn(w, mode="int8", tile=8)
    x = torch.from_numpy(rng.normal(size=(1, 6, D)).astype(np.float32))
    ms = tmp.MoEStatic(num_experts=E, top_k=K)
    a = tmp.moe_layer(x, qw, ms, TPC(blk=8, quant="fp8"))[0]
    b = tmp.moe_layer(x, qw, ms, TPC(blk=8))[0]
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_lm_qat_loss_and_grads_match_jax():
    """qwen3-moe smoke, f32, int8 at tile 16: one loss and every grad leaf
    (the JAX grads carried into the port's layout by ``params_from_jax``)."""
    arch = "qwen3-moe-30b-a3b"
    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32")
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32")
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    batch = TokenSource(DataConfig(seq_len=32, global_batch=2,
                                   vocab_size=cfg_t.vocab_size,
                                   seed=1)).batch(0)
    jloss = jsteps.make_loss_fn(
        cfg_j, JPC(blk=8, impl="pallas", quant="int8", quant_tile=16), None,
        (2, 32, cfg_j.d_model))
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = tsteps.make_loss_fn(cfg_t, TPC(blk=8, quant="int8",
                                           quant_tile=16))
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    ttotal, tm = tloss(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = torch.autograd.grad(ttotal, leaves)
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg_t,
                                       device="cpu"))
    assert len(want) == len(tg)
    for g, w in zip(tg, want):
        _close(g, w.numpy())
    # without QAT the loss differs
    plain, _ = tsteps.make_loss_fn(cfg_t, TPC(blk=8))(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(plain.detach()) != float(ttotal.detach())


def test_swin_qat_loss_and_grads_match_jax():
    """Swin-MoE-Small smoke, f32, fp8 QAT of the MLP experts (w1, w2; the
    biases and router untouched): one loss and every grad leaf."""
    cfg_j, cfg_t = jss.SMOKE_CONFIG, tss.SMOKE_CONFIG
    pt0 = tswin.init_swin(cfg_t, generator=torch.Generator().manual_seed(5),
                          device="cpu")
    rng = np.random.default_rng(5)
    pn = tree_map(lambda t: (t.numpy() + rng.normal(size=t.shape) * 0.05)
                  .astype(np.float32), pt0)
    pj = jax.tree.map(jnp.asarray, pn)
    pt = swin_params_from_jax(pn, cfg_t, device="cpu")
    images = rng.normal(size=(2, cfg_j.img_size, cfg_j.img_size,
                              cfg_j.in_chans)).astype(np.float32)
    labels = rng.integers(0, cfg_j.num_classes, size=2).astype(np.int32)
    jpcfg = JPC(blk=8, impl="pallas", fused_ffn=True, quant="fp8")

    def jloss(params):
        logits, aux, _ = jswin.swin_forward(params, jnp.asarray(images),
                                            cfg_j, jpcfg, None)
        onehot = jax.nn.one_hot(labels, cfg_j.num_classes)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return ce + 0.01 * aux

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pj)
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = tswin.make_loss_fn(cfg_t, TPC(blk=8, quant="fp8"))(
        pt, torch.from_numpy(images), torch.from_numpy(labels))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    want = tree_leaves(swin_params_from_jax(jax.tree.map(np.asarray, jg),
                                            cfg_t, device="cpu"))
    assert len(want) == len(tg)
    for g, w in zip(tg, want):
        _close(g, w.numpy())


def test_train_cli_quant_runs_on_cpu(capsys):
    log = ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                       "2", "--global-batch", "2", "--seq-len", "16",
                       "--layers", "1", "--device", "cpu", "--quant",
                       "int8"])
    assert [m["step"] for m in log] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert "[train] finished at step 2" in capsys.readouterr().out
    plain = ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                         "1", "--global-batch", "2", "--seq-len", "16",
                         "--layers", "1", "--device", "cpu"])
    assert plain[0]["loss"] != log[0]["loss"]
    with pytest.raises(SystemExit) as err:
        ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                     "cpu", "--quant", "int4"])
    assert err.value.code == 2
