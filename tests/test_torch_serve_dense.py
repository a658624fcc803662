"""PyTorch port vs the JAX package: the dense serving slice.

``decode_attention``, the dense KV cache (``init_cache``/``reset_slot``),
the dense prefill and decode steps, ``reference_stream`` and
``BatchedServer`` of the port on the CPU against the JAX package's on the
same numpy inputs and the same weights (carried over by
``params_from_jax``), on the f32 smoke configs of qwen3-moe-30b-a3b and
mixtral-8x7b (every layer windowed, window 16: its dense cache is a
16-row rolling buffer).

The JAX cache stacks layers per period position, ``[pos][name][j]`` with
a leading period axis ``j``; the port's is a per-layer list, layer
``j * period + pos``. ``_to_port_cache``/``_to_jax_layout`` map one onto
the other explicitly.

Tolerances: ``decode_attention`` in f32 at 1e-5 x max|ref| (the same
products, summed in another order); in bf16 at 2e-2 x max|ref| (p rounds
to bf16 before P V on both sides, and one bf16 rounding of p or of the
output moves it by up to 2^-8 relative, several ulps where roundings
meet). Step logits in f32 within atol 1e-4 (as the paged slice's prefill
logits), K/V cache rows within 1e-5 x max|ref|. Greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
JPCFG = JPC(blk=8, impl="pallas")
TPCFG = TPC(blk=8)
# tests/test_serve_parity.py's dense-decode matrix: 3 slots, max_seq 32,
# 6 requests from seed 13 (so slots refill mid-run)
MAX_SEQ, NUM_SLOTS, N_REQ = 32, 3, 6
KV_TOL = 1e-5                                     # x max|ref|
LOGIT_ATOL = 1e-4


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tcfglib.get_smoke_config(arch), dtype=dtype))


def _params(cfg_j, cfg_t, seed=0):
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(seed), cfg_j))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), cfg_t,
                               device="cpu")


def _close(got, want, tol_rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_rel * scale)


def _to_port_cache(jcache, cfg, dtype=torch.float32) -> dict:
    """The JAX dense cache (stacked per period position) as the port's
    per-layer list: JAX ``layers[pos][name][j]`` -> port layer
    ``j * period + pos``."""
    layers = []
    for li in range(cfg.num_layers):
        j, pos = divmod(li, cfg.period)
        layers.append({
            name: torch.from_numpy(np.array(
                jnp.asarray(a[j], jnp.float32))).to(dtype)
            for name, a in jcache["layers"][pos].items()})
    return {"layers": layers,
            "len": torch.from_numpy(np.array(jcache["len"]))}


def _to_jax_layout(tcache, cfg) -> list:
    """The port's per-layer list stacked per period position, as numpy
    f32: ``out[pos][name]`` has the leading period axis."""
    period = cfg.period
    return [{name: np.stack([tcache["layers"][j * period + pos][name]
                             .float().numpy()
                             for j in range(cfg.num_layers // period)])
             for name in tcache["layers"][pos]}
            for pos in range(period)]


def _requests(vocab, seed=13, wrap=False):
    """tests/test_serve_parity.py's requests; ``wrap`` adds one whose
    cache rows (prompt + fed-back outputs) pass the 16-token window."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(2, 14))
        out.append((i, rng.integers(0, vocab, size=plen).astype(np.int32),
                    int(rng.integers(1, 6))))
    if wrap:
        out.append((N_REQ, rng.integers(0, vocab, size=14).astype(np.int32),
                    12))
    return out


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_decode_attention_matches_jax(dtype, tol, softcap):
    b, s, hq, hkv, hd = 3, 24, 8, 2, 16
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    lens = np.array([1, 17, 24], np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jattn.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(lens), softcap=softcap)
    got = tattn.decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(lens), softcap=softcap)
    assert got.dtype == td and got.shape == want.shape
    _close(got, want, tol)
    # a length-1 slot reads row 0 alone: its output is V[0] (up to rounding)
    _close(got[0, 0], jnp.repeat(jnp.asarray(v[0, 0], jd), hq // hkv,
                                 axis=0), tol)


# ---------------------------------------------------------------------------
# the dense cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_reset_slot_match_jax(arch):
    cfg_j, cfg_t = _configs(arch, "bfloat16")
    jc = jlm.init_cache(cfg_j, NUM_SLOTS, MAX_SEQ)
    tc = tlm.init_cache(cfg_t, NUM_SLOTS, MAX_SEQ, "cpu")
    assert len(tc["layers"]) == cfg_t.num_layers
    rows = min(MAX_SEQ, cfg_t.window) if cfg_t.window else MAX_SEQ
    for li, layer in enumerate(tc["layers"]):
        j, pos = divmod(li, cfg_t.period)
        for name in ("k", "v"):
            t, a = layer[name], jc["layers"][pos][name][j]
            assert t.shape == a.shape == (NUM_SLOTS, rows, cfg_t.num_kv_heads,
                                          cfg_t.hd)
            assert t.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
            assert not t.any()
    assert tc["len"].dtype == torch.int32 and tc["len"].shape == (NUM_SLOTS,)
    assert tlm.cache_bytes(tc) == sum(
        a.size * a.dtype.itemsize for layer in jc["layers"]
        for a in layer.values())
    tc["len"][:] = torch.tensor([5, 9, 3], dtype=torch.int32)
    tc["layers"][0]["k"][1] = 1.0
    jc = {**jc, "len": jnp.asarray([5, 9, 3], jnp.int32)}
    tc = tlm.reset_slot(cfg_t, tc, 1)
    jc = jlm.reset_slot(cfg_j, jc, 1)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == [5, 0, 3]
    assert bool((tc["layers"][0]["k"][1] == 1.0).all()), \
        "reset_slot touches no K/V row"


# ---------------------------------------------------------------------------
# the dense steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("qwen3-moe-30b-a3b", 12),
                                    ("mixtral-8x7b", 12),
                                    ("mixtral-8x7b", 20)])
def test_prefill_step_matches_jax(arch, s):
    """The whole-prompt prefill: logits of the last row, the K/V cache
    (padded to max_seq; on mixtral at s 20 > window 16, the tail rolled so
    that position p lives at row p % 16) and every length set to s."""
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(cfg_j, cfg_t, seed=3)
    b = 2
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab_size, size=(b, s)).astype(np.int32)
    jstep = jsteps.make_prefill_step(cfg_j, JPCFG, None,
                                     (b, s, cfg_j.d_model))
    jlogits, jcache = jstep(pj, {"tokens": jnp.asarray(tokens)},
                            jlm.init_cache(cfg_j, b, MAX_SEQ))
    tstep = tsteps.make_prefill_step(cfg_t, TPCFG)
    tlogits, tcache = tstep(pt, {"tokens": torch.from_numpy(tokens)},
                            tlm.init_cache(cfg_t, b, MAX_SEQ, "cpu"))
    assert tlogits.shape == jlogits.shape == (b, 1, cfg_t.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist() \
        == [s] * b
    rolled = cfg_t.window and s > cfg_t.window
    got = _to_jax_layout(tcache, cfg_t)
    for pos, layer in enumerate(jcache["layers"]):
        for name, want in layer.items():
            assert got[pos][name].shape == want.shape
            _close(got[pos][name], want, KV_TOL)
            if rolled:
                # rows hold positions s-16..s-1, position p at p % 16
                assert want.shape[2] == cfg_t.window
    if rolled:
        # row p % 16 of the windowed buffer holds position p's K, for the
        # last 16 positions: layer 0's K from a cache that holds them all
        kfull = _full_k(pt, tokens, cfg_t)
        for p in range(s - cfg_t.window, s):
            np.testing.assert_array_equal(
                tcache["layers"][0]["k"][:, p % cfg_t.window].numpy(),
                kfull[:, p])


def _full_k(pt, tokens, cfg):
    """Layer 0's K rows at every prompt position, from a prefill into a
    cache that holds the whole prompt (no roll)."""
    wide = dataclasses.replace(cfg, window=0)
    _, cache = tsteps.make_prefill_step(wide, TPCFG)(
        pt, {"tokens": torch.from_numpy(tokens)},
        tlm.init_cache(wide, tokens.shape[0], tokens.shape[1], "cpu"))
    return cache["layers"][0]["k"].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    """One decode macro-step over a random dense cache with an inactive
    slot: logits and the written rows as JAX's; the inactive slot's rows
    and length stay exactly as they were (on mixtral its 16-row buffer is
    full, so row len % 16 holds its oldest readable token)."""
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(cfg_j, cfg_t, seed=4)
    b = NUM_SLOTS
    rng = np.random.default_rng(2)
    jc = jlm.init_cache(cfg_j, b, MAX_SEQ)
    lens = np.array([5, 20, 13], np.int32)
    active = np.array([True, False, True])
    jc = {"layers": [{name: jnp.asarray(rng.normal(size=a.shape), a.dtype)
                      for name, a in layer.items()}
                     for layer in jc["layers"]],
          "len": jnp.asarray(lens)}
    tc = _to_port_cache(jc, cfg_t)
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in tc["layers"]]
    tokens = rng.integers(0, cfg_j.vocab_size, size=(b, 1)).astype(np.int32)
    jstep = jsteps.make_serve_step(cfg_j, JPCFG, None, (b, 1, cfg_j.d_model))
    jlogits, jnew = jstep(pj, {"tokens": jnp.asarray(tokens),
                               "active": jnp.asarray(active)}, jc)
    tstep = tsteps.make_serve_step(cfg_t, TPCFG)
    tlogits, tnew = tstep(pt, {"tokens": torch.from_numpy(tokens),
                               "active": torch.from_numpy(active)}, tc)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    assert tnew["len"].tolist() == np.asarray(jnew["len"]).tolist() \
        == [6, 20, 14]
    got = _to_jax_layout(tnew, cfg_t)
    for pos, layer in enumerate(jnew["layers"]):
        for name, want in layer.items():
            _close(got[pos][name], want, KV_TOL)
    for layer, old in zip(tnew["layers"], before):
        for name in ("k", "v"):
            assert torch.equal(layer[name][1], old[name][1]), \
                "the inactive slot's rows changed"
            s_cache = old[name].shape[1]
            for slot in (0, 2):            # every other row as it was
                keep = torch.ones(s_cache, dtype=torch.bool)
                keep[int(lens[slot]) % s_cache] = False
                assert torch.equal(layer[name][slot][keep],
                                   old[name][slot][keep])


# ---------------------------------------------------------------------------
# the reference stream and the dense engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reference_stream_matches_jax(arch):
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(cfg_j, cfg_t)
    jstep = jax.jit(jsteps.make_serve_step(cfg_j, JPCFG, None,
                                           (1, 1, cfg_j.d_model)))
    tstep = tsteps.make_serve_step(cfg_t, TPCFG)
    reqs = _requests(cfg_j.vocab_size, wrap=True)
    for rid, prompt, max_new in (reqs[0], reqs[1], reqs[-1]):
        want = jserve.greedy_reference(cfg_j, JPCFG, None, pj, prompt,
                                       max_new, max_seq=MAX_SEQ, step=jstep)
        got = tserve.reference_stream(
            cfg_t, TPCFG, pt,
            tserve.Request(rid=rid, prompt=prompt, max_new=max_new),
            max_seq=MAX_SEQ, step=tstep)
        assert got == want and len(got) == max_new
        assert tserve.greedy_reference(cfg_t, TPCFG, pt, prompt, max_new,
                                       max_seq=MAX_SEQ, step=tstep) == want
    # the last request's cache rows pass the window: the buffer wrapped
    assert len(reqs[-1][1]) + reqs[-1][2] - 1 > 16


def _serve_dense(server, reqs, request_cls):
    for rid, prompt, max_new in reqs:
        server.submit(request_cls(rid=rid, prompt=prompt, max_new=max_new))
    return {r.rid: r.out for r in server.run()}


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_jax(arch):
    """The dense engine (masked macro-steps, mid-run slot refill) against
    the JAX one: the same tokens; on mixtral one request wraps its
    16-row rolling buffer."""
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(cfg_j, cfg_t)
    reqs = _requests(cfg_j.vocab_size, wrap=True)
    js = jserve.BatchedServer(cfg_j, JPCFG, None, num_slots=NUM_SLOTS,
                              max_seq=MAX_SEQ, params=pj)
    ts = tserve.BatchedServer(cfg_t, TPCFG, num_slots=NUM_SLOTS,
                              max_seq=MAX_SEQ, params=pt, device="cpu")
    jdone = _serve_dense(js, reqs, jserve.Request)
    tdone = _serve_dense(ts, reqs, tserve.Request)
    assert len(tdone) == len(reqs) and tdone == jdone
    assert ts.admissions == js.admissions == len(reqs) > NUM_SLOTS
    assert len(ts.decode_times_s) == len(js.decode_times_s)
    assert sorted(ts.ttft_s) == sorted(tdone)
    assert len(ts.free) == NUM_SLOTS and all(s is None for s in ts.slots)
    assert ts.kv_bytes() == tlm.cache_bytes(
        tlm.init_cache(cfg_t, NUM_SLOTS, MAX_SEQ, "cpu"))
    with pytest.raises(ValueError, match="max_seq"):
        ts.submit(tserve.Request(rid=99, prompt=np.arange(30), max_new=4))
    # a sampled request: JAX's reference stream, drawn on the dense engine
    sampled = dict(rid=98, prompt=np.arange(3), max_new=3, temperature=0.7,
                   seed=98)
    ts.submit(tserve.Request(**sampled))
    assert [r.out for r in ts.run()] == [jserve.reference_stream(
        cfg_j, JPCFG, None, pj, jserve.Request(**sampled), max_seq=MAX_SEQ)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_paged_server(arch):
    """The port's two engines differ only in cache layout, never in
    tokens; the dense one schedules only its ``valid_slots``."""
    _, cfg_t = _configs(arch)
    _, pt = _params(*_configs(arch))
    reqs = _requests(cfg_t.vocab_size, seed=11, wrap=True)
    dense = tserve.BatchedServer(cfg_t, TPCFG, num_slots=NUM_SLOTS,
                                 max_seq=MAX_SEQ, params=pt,
                                 valid_slots=[0, 2], device="cpu")
    used = set()
    step = dense.serve_step

    def spy(params, inputs, cache):
        used.update(torch.nonzero(inputs["active"]).flatten().tolist())
        return step(params, inputs, cache)

    dense.serve_step = spy
    maxp = MAX_SEQ // 4
    paged = tserve.PagedServer(cfg_t, TPCFG, num_slots=NUM_SLOTS,
                               page_size=4, num_pages=1 + NUM_SLOTS * maxp,
                               max_pages_per_slot=maxp, params=pt,
                               prefill_chunk=5, device="cpu")
    got = _serve_dense(dense, reqs, tserve.Request)
    want = _serve_dense(paged, reqs, tserve.Request)
    assert got == want and len(got) == len(reqs)
    assert used == {0, 2} and int(dense.cache["len"][1]) == 0
