"""PyTorch port vs the JAX package: serving stacks with recurrent mixers
and dense FFN layers.

jamba-1.5-large-398b's smoke config (one 8-layer period: 7 Mamba layers
and 1 attention layer, MoE FFNs on the odd layers and dense GLU FFNs on
the even ones) and xlstm-350m's (mLSTM and sLSTM blocks, no attention),
both in f32, from the same weights (``params_from_jax``); the JAX side
through ``ParallelConfig(blk=8, impl="pallas")``, its Pallas kernels in
interpret mode:

* ``PagedServer`` (3 slots, 4-token pages, chunks of 5; 6 requests, so
  slots are refilled and their recurrent state must be zeroed): streams,
  the whole scheduler ``trace`` and the pool's counters equal to JAX's,
  and the streams equal to the batch-1 ``reference_stream``;
* ``BatchedServer`` and ``reference_stream`` equal to JAX's;
* the disaggregated handoff moves the recurrent state
  (``tests/test_disagg.py``'s check), and the handoff and page-copy steps
  against JAX's on random caches; ``reset_slot`` zeroes exactly the
  slot's state rows;
* the prefix cache and speculation refused with JAX's messages;
* ``make_prefill_step`` (the chunked scans) against JAX's: last logits
  within 1e-4 and the final recurrent state within 1e-5 x max|ref|;
* what the port trains and serves: every LM configuration trains, the
  MLP-experts graft too; the engines (``check_servable``) take every
  configuration but musicgen-large's EnCodec frames and codebook heads.

The four dense decoders (gemma-2b, phi3-medium-14b, starcoder2-15b,
gemma3-12b) on their f32 smoke configs: forward logits within 1e-4 of
JAX's, and ``PagedServer`` streams and trace equal to JAX's. Tokens and
traces are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import serve as jserve
from repro.launch import spec as jspec
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import spec as tspec
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

HYBRID = ["jamba-1.5-large-398b", "xlstm-350m"]
DENSE = ["gemma-2b", "phi3-medium-14b", "starcoder2-15b", "gemma3-12b"]
JPCFG = JPC(blk=8, impl="pallas")
TPCFG = TPC(blk=8)
MAX_SEQ, NUM_SLOTS, PAGE, CHUNK, N_REQ = 32, 3, 4, 5, 6
MAXP = MAX_SEQ // PAGE
LOGIT_ATOL = 1e-4
STATE_TOL = 1e-5                                  # x max|ref|

_MODELS: dict = {}


def _models(arch):
    """(cfg_j, cfg_t, params_j, params_t) of the f32 smoke config."""
    if arch not in _MODELS:
        cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                    dtype="float32")
        cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                    dtype="float32")
        pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
        _MODELS[arch] = (cfg_j, cfg_t, pj, params_from_jax(
            jax.tree.map(np.asarray, pj), cfg_t, device="cpu"))
    return _MODELS[arch]


def _requests(vocab, n=N_REQ, seed=13):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(2, 12))).astype(np.int32),
        max_new=int(rng.integers(2, 7))) for i in range(n)]


def _paged(pkg, arch, reqs, **kw):
    cfg_j, cfg_t, pj, pt = _models(arch)
    common = dict(num_slots=NUM_SLOTS, page_size=PAGE,
                  num_pages=1 + NUM_SLOTS * MAXP, max_pages_per_slot=MAXP,
                  prefill_chunk=CHUNK)
    common.update(kw)
    if pkg == "jax":
        srv = jserve.PagedServer(cfg_j, JPCFG, None, params=pj, **common)
        req_cls = jserve.Request
    else:
        srv = tserve.PagedServer(cfg_t, TPCFG, params=pt, device="cpu",
                                 **common)
        req_cls = tserve.Request
    for r in reqs:
        srv.submit(req_cls(**r))
    return srv, {r.rid: r.out for r in srv.run()}


def _references(arch, reqs):
    _, cfg_t, _, pt = _models(arch)
    step = tsteps.make_serve_step(cfg_t, TPCFG)
    return {r["rid"]: tserve.reference_stream(
        cfg_t, TPCFG, pt, tserve.Request(**r), max_seq=MAX_SEQ, step=step)
        for r in reqs}


def _drained(srv):
    srv.assert_page_invariants()
    srv.pool.assert_consistent()
    assert srv.pool.free_pages == sum(srv.pool.shares)
    assert (srv.table == 0).all()


def _random_cache(cfg_j, cfg_t, paged: bool, seed=3):
    """A random JAX cache (dense, or paged with 7 pages) and the same
    values in the port's per-layer layout."""
    if paged:
        jc = jlm.init_paged_cache(cfg_j, NUM_SLOTS, 7, PAGE)
        tc = tlm.init_paged_cache(cfg_t, NUM_SLOTS, 7, PAGE, "cpu")
    else:
        jc = jlm.init_cache(cfg_j, NUM_SLOTS, MAX_SEQ)
        tc = tlm.init_cache(cfg_t, NUM_SLOTS, MAX_SEQ, "cpu")
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.integers(1, 20, size=a.shape).astype(np.int32)
        if a.dtype == jnp.int32 else rng.normal(size=a.shape).astype(
            a.dtype)), jc)
    tc["len"].copy_(torch.from_numpy(np.array(jc["len"])))
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        for name, t in layer.items():
            t.copy_(torch.from_numpy(np.array(jc["layers"][pos][name][j])))
    return jc, tc


def _assert_cache_equal(tc, jc, cfg_t):
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        assert sorted(layer) == sorted(jc["layers"][pos])
        for name, t in layer.items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jc["layers"][pos][name][j]))


# ---------------------------------------------------------------------------
# what the port serves and trains
# ---------------------------------------------------------------------------

def test_check_supported_and_the_train_path():
    """Every LM configuration builds its train step, the MLP-experts graft
    too; the serving engines take every configuration but musicgen-large
    (``check_servable``)."""
    for arch in HYBRID + DENSE + ["paligemma-3b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x7b"]:
        tlm.check_servable(tcfglib.get_config(arch))
    with pytest.raises(NotImplementedError, match="token prompts and one"):
        tlm.check_servable(tcfglib.get_config("musicgen-large"))
    cfg_m = dataclasses.replace(tcfglib.get_smoke_config("musicgen-large"),
                                dtype="float32")
    params_m = tlm.init_params(
        cfg_m, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="EnCodec frames"):
        tserve.BatchedServer(cfg_m, TPCFG, num_slots=2, max_seq=16,
                             params=params_m, device="cpu")
    graft = dataclasses.replace(tcfglib.get_smoke_config("qwen3-moe-30b-a3b"),
                                glu=False)
    tlm.check_servable(graft)
    for cfg in (graft, cfg_m):
        tsteps.make_train_step(cfg, TPCFG, tadamw.OptimizerConfig())
    _, cfg_t, _, _ = _models("jamba-1.5-large-398b")
    tsteps.make_train_step(cfg_t, TPCFG, tadamw.OptimizerConfig())
    for arch in ("xlstm-350m", "gemma-2b"):
        log = ttrain.main(["--arch", arch, "--smoke", "--steps", "1",
                           "--global-batch", "2", "--seq-len", "16",
                           "--device", "cpu"])
        assert len(log) == 1 and np.isfinite(log[0]["loss"])


# ---------------------------------------------------------------------------
# hybrid and recurrent stacks on both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", HYBRID)
def test_paged_server_matches_jax(arch):
    reqs = _requests(_models(arch)[1].vocab_size)
    jsrv, jout = _paged("jax", arch, reqs)
    tsrv, tout = _paged("torch", arch, reqs)
    assert tout == jout and len(tout) == N_REQ
    assert tsrv.trace == jsrv.trace
    assert tsrv.stats() == jsrv.stats()
    assert tsrv.admissions == N_REQ > NUM_SLOTS
    assert tout == _references(arch, reqs)
    _drained(tsrv)
    _assert_final_cache_close(tsrv, jsrv, _models(arch)[1])


def _assert_final_cache_close(tsrv, jsrv, cfg_t):
    """Both engines' caches after the run: every slot's recurrent state
    (a slot reused without zeroing it would carry the last request's) and
    every K/V page but the sink page 0 (which JAX's scan also writes with
    its padding tokens), within 1e-5 x max|ref|."""
    tc, jc = tsrv.cache, jsrv.cache
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        for name, t in layer.items():
            want = np.asarray(jc["layers"][pos][name][j])
            got = t.numpy()
            if li not in tlm.recurrent_layers(cfg_t):
                got, want = got[1:], want[1:]
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=STATE_TOL * max(float(np.abs(want).max()), 1.0),
                err_msg=f"layer {li} {name}")


@pytest.mark.parametrize("arch", HYBRID)
def test_batched_server_and_reference_stream_match_jax(arch):
    cfg_j, cfg_t, pj, pt = _models(arch)
    reqs = _requests(cfg_t.vocab_size, seed=17)
    js = jserve.BatchedServer(cfg_j, JPCFG, None, num_slots=NUM_SLOTS,
                              max_seq=MAX_SEQ, params=pj)
    ts = tserve.BatchedServer(cfg_t, TPCFG, num_slots=NUM_SLOTS,
                              max_seq=MAX_SEQ, params=pt, device="cpu")
    outs = []
    for srv, cls in ((js, jserve.Request), (ts, tserve.Request)):
        for r in reqs:
            srv.submit(cls(**r))
        outs.append({r.rid: r.out for r in srv.run()})
    assert outs[1] == outs[0] and len(outs[1]) == N_REQ
    assert ts.admissions == N_REQ
    _assert_final_cache_close(ts, js, cfg_t)
    jstep = jax.jit(jsteps.make_serve_step(cfg_j, JPCFG, None,
                                           (1, 1, cfg_j.d_model)))
    refs = _references(arch, reqs)
    for r in reqs[:2]:
        assert refs[r["rid"]] == jserve.greedy_reference(
            cfg_j, JPCFG, None, pj, r["prompt"], r["max_new"],
            max_seq=MAX_SEQ, step=jstep)
    assert outs[1] == refs


@pytest.mark.parametrize("arch", HYBRID)
def test_disagg_handoff_moves_recurrent_state(arch):
    """Half/half roles: every request hands its slot's recurrent state
    over with its table row; the streams are the single-loop engine's, on
    both packages, with the same trace."""
    reqs = _requests(_models(arch)[1].vocab_size, n=4, seed=23)
    _, single = _paged("torch", arch, reqs, num_slots=4,
                       num_pages=1 + 4 * MAXP)
    jsrv, jout = _paged("jax", arch, reqs, num_slots=4,
                        num_pages=1 + 4 * MAXP, disagg=True)
    tsrv, tout = _paged("torch", arch, reqs, num_slots=4,
                        num_pages=1 + 4 * MAXP, disagg=True)
    assert tsrv.transfers == len(reqs)
    assert tout == single == jout, "recurrent state lost in handoff"
    assert tsrv.trace == jsrv.trace


@pytest.mark.parametrize("arch", HYBRID)
def test_handoff_copy_and_reset_steps_match_jax(arch):
    cfg_j, cfg_t, _, _ = _models(arch)
    jc, tc = _random_cache(cfg_j, cfg_t, paged=True)
    jc = jsteps.make_page_copy_step(cfg_j)(jc, jnp.int32(2), jnp.int32(5))
    tc = tsteps.make_page_copy_step(cfg_t)(tc, 2, 5)
    jc = jsteps.make_paged_handoff_step(cfg_j)(jc, jnp.int32(0),
                                               jnp.int32(2))
    tc = tsteps.make_paged_handoff_step(cfg_t)(tc, 0, 2)
    _assert_cache_equal(tc, jc, cfg_t)
    rec = tlm.recurrent_layers(cfg_t)
    assert rec and not any(t[0].any() for li in rec
                           for t in tc["layers"][li].values())
    for paged in (False, True):
        jc, tc = _random_cache(cfg_j, cfg_t, paged=paged, seed=5)
        jc = jlm.reset_slot(cfg_j, jc, 1)
        tc = tlm.reset_slot(cfg_t, tc, 1)
        _assert_cache_equal(tc, jc, cfg_t)
    with pytest.raises(ValueError, match="all-attention"):
        tlm.reset_slot(cfg_t, tc, 1, length=4)


@pytest.mark.parametrize("arch", HYBRID)
def test_prefill_step_matches_jax(arch):
    """The chunked scans (``make_prefill_step``): the last logits, every
    slot's length and the final recurrent state as JAX's; the logits also
    as the token-wise decode path's."""
    cfg_j, cfg_t, pj, pt = _models(arch)
    b, s = 2, 12
    tokens = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, size=(b, s)).astype(np.int32)
    jlogits, jc = jsteps.make_prefill_step(cfg_j, JPCFG, None,
                                           (b, s, cfg_j.d_model))(
        pj, {"tokens": jnp.asarray(tokens)}, jlm.init_cache(cfg_j, b,
                                                            MAX_SEQ))
    tlogits, tc = tsteps.make_prefill_step(cfg_t, TPCFG)(
        pt, {"tokens": torch.from_numpy(tokens)},
        tlm.init_cache(cfg_t, b, MAX_SEQ, "cpu"))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGIT_ATOL)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [s] * b
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        for name, t in layer.items():
            want = np.asarray(jc["layers"][pos][name][j])
            np.testing.assert_allclose(
                t.numpy(), want, rtol=0,
                atol=STATE_TOL * max(float(np.abs(want).max()), 1.0))
    step = tsteps.make_serve_step(cfg_t, TPCFG)
    cache = tlm.init_cache(cfg_t, b, MAX_SEQ, "cpu")
    for t in range(s):
        logits, cache = step(pt, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1])}, cache)
    np.testing.assert_allclose(tlogits.numpy(), logits.numpy(), rtol=0,
                               atol=LOGIT_ATOL)


def test_prefix_cache_and_speculation_refused_as_jax():
    arch = "jamba-1.5-large-398b"
    cfg_j, cfg_t, pj, pt = _models(arch)
    common = dict(num_slots=2, page_size=PAGE, num_pages=9,
                  max_pages_per_slot=4)

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    want = message(lambda: jserve.PagedServer(cfg_j, JPCFG, None, params=pj,
                                              prefix_cache=True, **common))
    assert "prefix_cache requires an all-attention stack" in want
    assert message(lambda: tserve.PagedServer(
        cfg_t, TPCFG, params=pt, device="cpu", prefix_cache=True,
        **common)) == want
    jsrv = jserve.PagedServer(cfg_j, JPCFG, None, params=pj, **common)
    tsrv = tserve.PagedServer(cfg_t, TPCFG, params=pt, device="cpu", **common)
    want = message(lambda: jspec.SpecDecoder(jsrv, jspec.NGramDrafter()))
    assert message(lambda: tspec.SpecDecoder(
        tsrv, tspec.NGramDrafter())) == want
    assert tsrv.spec is None
    want = message(lambda: jspec.ModelDrafter(cfg_j, JPCFG, None, pj,
                                              max_seq=MAX_SEQ))
    assert message(lambda: tspec.ModelDrafter(cfg_t, TPCFG, pt,
                                              max_seq=MAX_SEQ,
                                              device="cpu")) == want
    want = message(lambda: jsteps.make_paged_score_step(cfg_j, JPCFG, None,
                                                        PAGE))
    assert message(lambda: tsteps.make_paged_score_step(
        cfg_t, TPCFG, PAGE)) == want
    with pytest.raises(ValueError, match="all-attention"):
        tlm.rollback_slot(cfg_t, tsrv.cache, 0, 1)


def test_cli_serves_the_hybrid_and_recurrent_stacks(capsys):
    for arch, extra in (("jamba-1.5-large-398b", ["--paged", "--disagg"]),
                        ("xlstm-350m", ["--paged"]), ("xlstm-350m", [])):
        done = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--slots", "2", "--requests", "3", "--max-new",
                            "3", "--max-seq", "32", *extra])
        out = capsys.readouterr().out
        assert len(done) == 3 and all(len(r.out) == 3 for r in done)
        if "--paged" in extra:
            assert "leak-free=True" in out
    with pytest.raises(ValueError, match="prefix_cache requires"):
        tserve.main(["--arch", "jamba-1.5-large-398b", "--smoke", "--device",
                     "cpu", "--paged", "--prefix-cache"])


# ---------------------------------------------------------------------------
# dense decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_decoder_logits_match_jax(arch):
    cfg_j, cfg_t, pj, pt = _models(arch)
    tokens = np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, size=(2, 20)).astype(np.int32)
    jlogits, _, _, _ = jlm.forward(pj, {"tokens": jnp.asarray(tokens)},
                                   cfg_j, JPCFG, None, mode="train")
    tlogits, _, _, _ = tlm.forward(pt, {"tokens": torch.from_numpy(tokens)},
                                   cfg_t, TPCFG, mode="train")
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decoder_paged_streams_match_jax(arch):
    reqs = _requests(_models(arch)[1].vocab_size, seed=29)
    jsrv, jout = _paged("jax", arch, reqs)
    tsrv, tout = _paged("torch", arch, reqs)
    assert tout == jout and len(tout) == N_REQ
    assert tsrv.trace == jsrv.trace
    assert tout == _references(arch, reqs)
    _drained(tsrv)
