"""PyTorch port vs the JAX package: speculative decoding on the paged
engine.

On the CPU, at the f32 smoke configs of qwen3-moe-30b-a3b and
mixtral-8x7b (every layer windowed, window 16), with the JAX side as its
own tests run it (``ParallelConfig(blk=8, impl="pallas")``, Pallas in
interpret mode) and the weights carried over by ``params_from_jax``:

- ``NGramDrafter``: the JAX suite's cases, and JAX's drafter's proposals
  on random histories;
- ``make_paged_score_step``: its rows against JAX's (atol 1e-4, as the
  paged slice's prefill logits) and against sequential one-token score
  steps (2e-5, as the JAX suite), and a padded tail changes no live row;
- ``PagePool.rollback`` against JAX's pool, and its refusals;
  ``lm.rollback_slot``; recurrent stacks refused;
- the stream matrix: speculation on == off == the port's
  ``reference_stream`` == JAX's, greedy and seeded-temperature requests
  mixed, with the counters of JAX's speculative engine, the pool checked
  after every tick and drained at the end;
- a drafter wrong by construction (it drafts ``(true + 1) % V`` from the
  non-speculative stream): no draft accepted, every drafted row rolled
  back, the same streams (on mixtral a request's rows pass the window, so
  rollback meets page reclamation);
- ``ModelDrafter`` drafting with the target's own config and params:
  acceptance 1.0 on greedy requests, its caches freed;
- the CLI's argparse errors and its speculative stats line.
"""
import dataclasses
from types import SimpleNamespace

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
from repro.parallel.cache import PagePool as JPool
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import spec as tspec
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.parallel.cache import PagePool as TPool
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
JPCFG = JPC(blk=8, impl="pallas")
TPCFG = TPC(blk=8)
# tests/test_serve_parity.py's paged matrix: 3 slots, 4-token pages,
# max_seq 32, 6 requests (slots refill mid-run), chunks of 5, k 3
MAX_SEQ, NUM_SLOTS, PAGE, N_REQ, CHUNK, SPEC_K = 32, 3, 4, 6, 5, 3
MAXP = MAX_SEQ // PAGE
LOGIT_ATOL = 1e-4
SEQ_TOL = 2e-5


def _configs(arch):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32"),
            dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32"))


_PARAMS: dict = {}


def _params(arch):
    """(cfg_j, cfg_t, params_j, params_t) from PRNGKey(0), built once."""
    if arch not in _PARAMS:
        cfg_j, cfg_t = _configs(arch)
        pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
        _PARAMS[arch] = (cfg_j, cfg_t, pj, params_from_jax(
            jax.tree.map(np.asarray, pj), cfg_t, device="cpu"))
    return _PARAMS[arch]


def _spec_requests(vocab, seed, long=False):
    """Greedy + seeded-temperature mix (odd rids sample at 0.8 with seed
    1000 + rid), max_new >= 3 so speculation has room; ``long`` adds a
    request whose cache rows pass mixtral's 16-token window."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(N_REQ):
        plen = int(rng.integers(2, 14))
        r = dict(rid=i, prompt=rng.integers(0, vocab, size=plen).astype(
            np.int32), max_new=max(int(rng.integers(1, 6)), 3))
        if i % 2:
            r.update(temperature=0.8, seed=1000 + i)
        reqs.append(r)
    if long:
        reqs.append(dict(rid=N_REQ, prompt=rng.integers(
            0, vocab, size=14).astype(np.int32), max_new=12,
            temperature=0.8, seed=1000 + N_REQ))
    return reqs


def _audit(server):
    """The pool's books and every live slot's pages and table row agree."""
    server.pool.assert_consistent()
    live = []
    for slot, st in enumerate(server.slots):
        if st is None:
            assert not server.table[slot].any()
            continue
        assert server.table[slot, :len(st.pages)].tolist() == st.pages
        assert not server.table[slot, len(st.pages):].any()
        live += [p for p in st.pages if p != 0]
        assert st.length == int(server.cache["len"][slot])
        assert len(st.pages) == -(-st.length // server.page_size)
    assert sorted(live) == sorted(server.pool._ref)


def _run_paged(cfg, params, reqs, drafter=None, k=SPEC_K):
    """Serve ``reqs`` through the port's PagedServer (speculation on when
    ``drafter`` is given), auditing the pool after every tick; window
    reclamation adds ``("reclaim", rid, slot, pages)`` to the trace."""
    server = tserve.PagedServer(
        cfg, TPCFG, num_slots=NUM_SLOTS, page_size=PAGE,
        num_pages=1 + NUM_SLOTS * MAXP, max_pages_per_slot=MAXP,
        params=params, prefill_chunk=CHUNK, device="cpu")
    if drafter is not None:
        tspec.SpecDecoder(server, drafter, k=k)
    for name in ("_prefill_tick", "_decode_tick"):
        tick = getattr(server, name)

        def audited(done, tick=tick):
            out = tick(done)
            _audit(server)
            return out

        setattr(server, name, audited)
    reclaim = server._reclaim

    def traced_reclaim(slot, st):
        before = st.reclaimed
        reclaim(slot, st)
        if st.reclaimed > before:
            server.trace.append(("reclaim", st.req.rid, slot,
                                 st.reclaimed - before))

    server._reclaim = traced_reclaim
    for r in reqs:
        server.submit(tserve.Request(**r))
    done = server.run()
    assert len(done) == len(reqs)
    _assert_drained(server)
    return server, {r.rid: r.out for r in done}


def _assert_drained(server):
    server.pool.assert_consistent()
    assert server.pool.free_pages == server.pool.num_pages - 1
    assert server.pool.in_use_pages == server.pool.reserved_pages == 0
    assert (server.table == 0).all()


# ---------------------------------------------------------------------------
# n-gram drafter (tests/test_spec.py's cases)
# ---------------------------------------------------------------------------

def test_ngram_drafts_most_recent_continuation():
    d = tspec.NGramDrafter(n=2)
    h = np.array([7, 8, 1, 2, 7, 8, 3, 4, 7, 8])
    assert d.draft(h, 3) == [3, 4, 7]


def test_ngram_prefers_longest_suffix_match():
    d = tspec.NGramDrafter(n=3)
    h = np.array([1, 2, 3, 9, 3, 5, 1, 2, 3])
    assert d.draft(h, 2) == [9, 3]


def test_ngram_falls_back_to_shorter_orders():
    d = tspec.NGramDrafter(n=3)
    assert d.draft(np.array([4, 1, 2, 4]), 2) == [1, 2]


def test_ngram_empty_without_repetition_and_caps_k():
    d = tspec.NGramDrafter(n=3)
    assert d.draft(np.array([1, 2, 3, 4, 5]), 4) == []
    assert d.draft(np.array([6, 6, 6, 6, 6]), 2) == [6, 6]
    assert d.draft(np.array([6, 6]), 3) == [6]
    assert d.draft(np.array([1, 2]), 0) == []
    with pytest.raises(ValueError):
        tspec.NGramDrafter(n=0)


@pytest.mark.parametrize("n", [1, 3])
def test_ngram_matches_jax_on_random_histories(n):
    rng = np.random.default_rng(n)
    jd, td = jspec.NGramDrafter(n=n), tspec.NGramDrafter(n=n)
    for _ in range(300):
        h = rng.integers(0, 5, size=int(rng.integers(1, 30)))
        k = int(rng.integers(0, 6))
        assert td.draft(h, k) == jd.draft(h, k)


# ---------------------------------------------------------------------------
# the multi-token score step
# ---------------------------------------------------------------------------

def _score(arch, tokens, width, n_valid, one_by_one=False):
    """The port's score rows of ``tokens`` from an empty slot 0 (pages 1-4
    in order), in one chunk of ``width`` or one token a call; returns
    (rows (n_valid, V), cache)."""
    _, cfg, _, params = _params(arch)
    step = tsteps.make_paged_score_step(cfg, TPCFG, PAGE)
    cache = tlm.init_paged_cache(cfg, 1, 5, PAGE, "cpu")
    table = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32)
    if one_by_one:
        rows = []
        for t in tokens[:n_valid]:
            r, cache = step(params, torch.tensor([t], dtype=torch.int32), 1,
                            0, table, cache)
            rows.append(r[0])
        return torch.stack(rows), cache
    toks = np.zeros((width,), np.int32)
    toks[:n_valid] = tokens[:n_valid]
    rows, cache = step(params, torch.from_numpy(toks), n_valid, 0, table,
                       cache)
    assert rows.shape == (width, cfg.vocab_size) and rows.dtype == \
        torch.float32
    return rows[:n_valid], cache


@pytest.mark.parametrize("arch", ARCHS)
def test_score_step_matches_jax_and_sequential_rows(arch):
    cfg_j, cfg_t, pj, _ = _params(arch)
    tokens = (np.arange(1, 9, dtype=np.int32) * 7) % cfg_t.vocab_size
    jstep = jax.jit(jsteps.make_paged_score_step(cfg_j, JPCFG, None, PAGE))
    jrows, jcache = jstep(
        pj, jnp.asarray(tokens), jnp.int32(8), jnp.int32(0),
        jnp.asarray(np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)),
        jlm.init_paged_cache(cfg_j, num_slots=1, num_pages=5,
                             page_size=PAGE))
    rows, cache = _score(arch, tokens, 8, 8)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=0,
                               atol=LOGIT_ATOL)
    assert int(cache["len"][0]) == int(jcache["len"][0]) == 8
    seq, seq_cache = _score(arch, tokens, 1, 8, one_by_one=True)
    np.testing.assert_allclose(rows.numpy(), seq.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    assert int(seq_cache["len"][0]) == 8
    # the last row is what the prefill step gives for the same chunk
    prefill = tsteps.make_paged_prefill_step(cfg_t, TPCFG, PAGE)
    last, _ = prefill(_params(arch)[3], torch.from_numpy(tokens), 8, 0,
                      torch.tensor([1, 2, 3, 4, 0, 0, 0, 0],
                                   dtype=torch.int32),
                      tlm.init_paged_cache(cfg_t, 1, 5, PAGE, "cpu"))
    np.testing.assert_allclose(rows[-1].numpy(), last.numpy(), rtol=0,
                               atol=SEQ_TOL)


def test_score_step_padded_tail_is_inert():
    """Rows at and past n_valid write to the sink page only: the live rows'
    logits, the length and every allocated page are as without them."""
    arch = "qwen3-moe-30b-a3b"
    tokens = np.arange(1, 4, dtype=np.int32)
    exact, c_exact = _score(arch, tokens, 3, 3)
    padded, c_padded = _score(arch, tokens, 8, 3)
    np.testing.assert_allclose(exact.numpy(), padded.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    assert int(c_exact["len"][0]) == int(c_padded["len"][0]) == 3
    for le, lp in zip(c_exact["layers"], c_padded["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(le[name][1:].numpy(),
                                       lp[name][1:].numpy(), rtol=SEQ_TOL,
                                       atol=SEQ_TOL)
            assert not le[name][1, 3:].any() and not lp[name][1, 3:].any()


def test_recurrent_and_codebook_stacks_are_refused():
    jamba = tcfglib.get_smoke_config("jamba-1.5-large-398b")
    with pytest.raises(ValueError, match="all-attention"):
        tsteps.make_paged_score_step(jamba, TPCFG, PAGE)
    server = SimpleNamespace(cfg=jamba, pcfg=TPCFG, page_size=PAGE,
                             spec=None)
    with pytest.raises(ValueError, match="all-attention"):
        tspec.SpecDecoder(server, tspec.NGramDrafter(), k=3)
    assert server.spec is None, "a refused decoder must not attach"
    with pytest.raises(ValueError, match="all-attention"):
        tlm.rollback_slot(jamba, {"len": torch.zeros(2, dtype=torch.int32)},
                          0, 1)
    with pytest.raises(ValueError, match="all-attention"):
        tspec.ModelDrafter(jamba, TPCFG, {}, max_seq=32, device="cpu")
    music = tcfglib.get_smoke_config("musicgen-large")
    with pytest.raises(ValueError, match="codebook"):
        tsteps.make_paged_score_step(
            dataclasses.replace(music, cross_attn=False), TPCFG, PAGE)


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

def test_pool_rollback_matches_jax():
    """The same reserve/alloc/rollback/release sequence on both pools: the
    same page ids and books; rolled-back pages return to the reservation
    (the free budget stays) and can be allocated again."""
    jp, tp = JPool(17, page_bytes=8), TPool(17, page_bytes=8)
    rng = np.random.default_rng(7)
    held = []                              # [pages, reserved, allocated]
    for _ in range(300):
        op = int(rng.integers(4))
        if op == 0:
            n = int(rng.integers(1, 6))
            ok = jp.try_reserve(n)
            assert tp.try_reserve(n) == ok
            if ok:
                held.append([[], n, 0])
        elif op == 1 and held:
            h = held[int(rng.integers(len(held)))]
            if h[2] < h[1]:
                page = jp.alloc()
                assert tp.alloc() == page
                h[0].append(page)
                h[2] += 1
        elif op == 2 and held:
            h = held[int(rng.integers(len(held)))]
            n = int(rng.integers(0, len(h[0]) + 1))
            pages = [h[0].pop() for _ in range(n)]
            free = tp.free_pages
            jp.rollback(pages)
            tp.rollback(pages)
            h[2] -= n
            assert tp.free_pages == free
        elif held:
            pages, res, alloc = held.pop(int(rng.integers(len(held))))
            jp.release(pages, unused_reserved=res - alloc)
            tp.release(pages, unused_reserved=res - alloc)
        tp.assert_consistent()
        want = jp.stats()
        assert tp.stats() == {k: want[k] for k in tp.stats()}
    assert tp.stats()["total_rollbacks"] > 0


def test_pool_rollback_refusals_change_nothing():
    pool = TPool(9, page_bytes=1)
    assert pool.try_reserve(3)
    a, b = pool.alloc(), pool.alloc()
    before = (pool.stats(), list(pool._free_list), dict(pool._ref))
    for pages, err, match in (([0], ValueError, "bad page"),
                              ([9], ValueError, "bad page"),
                              ([a, 8], RuntimeError, "not in use"),
                              ([a, a], ValueError, "twice")):
        with pytest.raises(err, match=match):
            pool.rollback(pages)
        assert (pool.stats(), list(pool._free_list), dict(pool._ref)) == \
            before
        pool.assert_consistent()
    pool.rollback([b])
    assert pool.reserved_pages == 2 and pool.in_use_pages == 1
    pool.release([a], unused_reserved=2)
    pool.assert_consistent()
    assert pool.free_pages == 8


def test_rollback_slot_truncates_length():
    _, cfg, _, _ = _params("qwen3-moe-30b-a3b")
    cache = tlm.init_paged_cache(cfg, 2, 5, PAGE, "cpu")
    cache["len"][1] = 9
    k0 = cache["layers"][0]["k"].clone()
    cache = tlm.rollback_slot(cfg, cache, 1, 6)
    assert cache["len"].tolist() == [0, 6]
    assert torch.equal(cache["layers"][0]["k"], k0)
    with pytest.raises(ValueError, match="negative"):
        tlm.rollback_slot(cfg, cache, 1, -1)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_spec_stream_parity(arch):
    """Speculation on == off == the port's and JAX's batch-1 references,
    greedy and sampled; the verify rounds, drafts and acceptances as JAX's
    speculative engine counts them."""
    cfg_j, cfg_t, pj, pt = _params(arch)
    reqs = _spec_requests(cfg_t.vocab_size, seed=47)
    jstep = jax.jit(jsteps.make_serve_step(cfg_j, JPCFG, None,
                                           (1, 1, cfg_j.d_model)))
    want = {r["rid"]: jserve.reference_stream(
        cfg_j, JPCFG, None, pj, jserve.Request(**r), max_seq=MAX_SEQ,
        step=jstep) for r in reqs}
    tstep = tsteps.make_serve_step(cfg_t, TPCFG)
    ref = {r["rid"]: tserve.reference_stream(
        cfg_t, TPCFG, pt, tserve.Request(**r), max_seq=MAX_SEQ, step=tstep)
        for r in reqs}
    _, out_off = _run_paged(cfg_t, pt, reqs)
    srv, out_on = _run_paged(cfg_t, pt, reqs, tspec.NGramDrafter())
    assert out_on == out_off == ref == want, f"{arch}: streams diverged"
    sp = srv.spec.stats()
    assert sp["rounds"] > 0
    assert sp["rollback_tokens"] + sp["accepted_drafts"] <= sp["drafted"]
    assert sum(ev[0] == "spec_verify" for ev in srv.trace) == sp["rounds"]
    # JAX's speculative engine on the same requests: the same counters
    jsrv = jserve.PagedServer(
        cfg_j, JPCFG, None, num_slots=NUM_SLOTS, page_size=PAGE,
        num_pages=1 + NUM_SLOTS * MAXP, max_pages_per_slot=MAXP, params=pj,
        prefill_chunk=CHUNK)
    jspec.SpecDecoder(jsrv, jspec.NGramDrafter(), k=SPEC_K)
    for r in reqs:
        jsrv.submit(jserve.Request(**r))
    assert {r.rid: r.out for r in jsrv.run()} == want
    assert sp == jsrv.spec.stats()
    spec_events = ("spec_verify", "rollback")
    assert [e for e in srv.trace if e[0] in spec_events] == \
        [e for e in jsrv.trace if e[0] in spec_events]


class _OracleDrafter:
    """Drafts the non-speculative stream's own next tokens: right by
    construction, so every draft of every request, greedy or sampled, is
    accepted (row ``i`` of a round must draw at step ``len(out) + i``)."""

    def __init__(self, reqs, streams):
        self.plen = {r["rid"]: len(r["prompt"]) for r in reqs}
        self.streams = streams

    def draft(self, history, k, rid=-1):
        pos = len(history) - self.plen[rid]
        return list(self.streams[rid][pos:pos + k])


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_oracle_drafter_accepts_every_draft(arch):
    _, cfg, _, params = _params(arch)
    reqs = _spec_requests(cfg.vocab_size, seed=59, long=True)
    _, out_off = _run_paged(cfg, params, reqs)
    srv, out_on = _run_paged(cfg, params, reqs,
                             _OracleDrafter(reqs, out_off))
    assert out_on == out_off
    sp = srv.spec.stats()
    assert sp["drafted"] > 0 and sp["acceptance_rate"] == 1.0, sp
    assert sp["rollback_tokens"] == 0
    assert not any(ev[0] == "rollback" for ev in srv.trace)
    # each request took ceil((max_new - 1) / (k + 1)) rounds, not max_new - 1
    assert sp["rounds"] == sum(-(-(r["max_new"] - 1) // (SPEC_K + 1))
                               for r in reqs)


class _WrongDrafter:
    """Drafts ``(true + 1) % V`` where ``true`` is the non-speculative
    stream's token at that position: wrong by construction, so every
    round rejects at its first draft."""

    def __init__(self, reqs, streams, vocab):
        self.plen = {r["rid"]: len(r["prompt"]) for r in reqs}
        self.streams, self.vocab = streams, vocab

    def draft(self, history, k, rid=-1):
        pos = len(history) - self.plen[rid]
        return [(t + 1) % self.vocab for t in self.streams[rid][pos:pos + k]]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_wrong_drafter_rolls_back_every_draft(arch):
    _, cfg, _, params = _params(arch)
    reqs = _spec_requests(cfg.vocab_size, seed=53, long=True)
    _, out_off = _run_paged(cfg, params, reqs)
    srv, out_on = _run_paged(
        cfg, params, reqs, _WrongDrafter(reqs, out_off, cfg.vocab_size))
    assert out_on == out_off
    sp = srv.spec.stats()
    assert sp["drafted"] > 0 and sp["accepted_drafts"] == 0
    assert sp["rollback_tokens"] == sp["drafted"]
    assert any(ev[0] == "rollback" for ev in srv.trace)
    if srv.reclaim_window is not None:      # mixtral: every layer windowed
        # the long request rolls back after pages behind its window went
        first = next(i for i, ev in enumerate(srv.trace)
                     if ev[:2] == ("reclaim", N_REQ))
        assert any(ev[:2] == ("rollback", N_REQ)
                   for ev in srv.trace[first:])


def test_model_drafter_self_draft_full_acceptance():
    """Drafting with the target's own config and params proposes exactly
    what greedy verification draws: acceptance 1.0, the same streams, and
    every per-request draft cache freed."""
    _, cfg, _, params = _params("qwen3-moe-30b-a3b")
    reqs = [dict(r, max_new=max(r["max_new"], 4), temperature=0.0)
            for r in _spec_requests(cfg.vocab_size, seed=67)]
    drafter = tspec.ModelDrafter(cfg, TPCFG, params, max_seq=MAX_SEQ,
                                 device="cpu")
    _, out_off = _run_paged(cfg, params, reqs)
    srv, out_on = _run_paged(cfg, params, reqs, drafter)
    assert out_on == out_off
    sp = srv.spec.stats()
    assert sp["drafted"] > 0 and sp["acceptance_rate"] == 1.0, sp
    assert not drafter._state, "finished requests kept draft caches"


def test_model_drafter_drafts_its_own_greedy_stream():
    _, cfg, _, params = _params("qwen3-moe-30b-a3b")
    drafter = tspec.ModelDrafter(cfg, TPCFG, params, max_seq=32,
                                 device="cpu")
    hist = np.array([3, 1, 4, 1, 5], np.int32)
    ref = tserve.greedy_reference(cfg, TPCFG, params, hist, 6, max_seq=32)
    assert drafter.draft(hist, 3, rid=7) == ref[:3]
    hist2 = np.concatenate([hist, np.asarray(ref[:3], np.int32)])
    assert drafter.draft(hist2, 3, rid=7) == ref[3:6]
    assert len(drafter.draft(np.arange(31, dtype=np.int32), 4, rid=8)) == 1
    assert drafter.draft(np.arange(32, dtype=np.int32), 4, rid=9) == []
    drafter.drop(7)
    drafter.drop(7)
    assert 7 not in drafter._state


def test_model_drafter_refuses_unsafe_configs():
    windowed = tcfglib.get_smoke_config("mixtral-8x7b")
    with pytest.raises(ValueError, match="non-windowed"):
        tspec.ModelDrafter(windowed, TPCFG, {}, max_seq=32, device="cpu")
    # a dense-FFN draft model (gemma-2b) builds and drafts what the JAX
    # drafter drafts from the same weights
    dcfg_j, dcfg_t, dpj, dpt = _params("gemma-2b")
    dense = tspec.ModelDrafter(dcfg_t, TPCFG, dpt, max_seq=32, device="cpu")
    jdense = jspec.ModelDrafter(dcfg_j, JPCFG, None, dpj, max_seq=32)
    hist = np.array([3, 1, 4, 1, 5], np.int32)
    drafted = dense.draft(hist, 3, rid=1)
    assert drafted == jdense.draft(hist, 3, rid=1) and len(drafted) == 3
    _, cfg, _, params = _params("qwen3-moe-30b-a3b")
    server = tserve.PagedServer(cfg, TPCFG, num_slots=2, page_size=PAGE,
                                num_pages=9, max_pages_per_slot=4,
                                params=params, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        tspec.SpecDecoder(server, tspec.NGramDrafter(), k=0)
    assert server.spec is None
    dec = tspec.SpecDecoder(server, tspec.NGramDrafter(), k=3)
    assert server.spec is dec and dec.chunk == 4


def test_verify_refuses_bad_drafts_and_non_finite_logits():
    _, cfg, _, params = _params("qwen3-moe-30b-a3b")

    class Far:
        def draft(self, history, k, rid=-1):
            return [cfg.vocab_size] * k

    req = dict(rid=0, prompt=np.arange(3), max_new=4)
    server = tserve.PagedServer(cfg, TPCFG, num_slots=1, page_size=PAGE,
                                num_pages=5, max_pages_per_slot=4,
                                params=params, device="cpu")
    tspec.SpecDecoder(server, Far(), k=2)
    server.submit(tserve.Request(**req))
    with pytest.raises(ValueError, match="vocabulary"):
        server.run()
    # non-finite verify logits abort and retry the request, never raise;
    # past its retries it fails with the reason, its pages returned
    server = tserve.PagedServer(cfg, TPCFG, num_slots=1, page_size=PAGE,
                                num_pages=5, max_pages_per_slot=4,
                                params=params, max_retries=1, audit=True,
                                device="cpu")
    spec = tspec.SpecDecoder(server, tspec.NGramDrafter(), k=2)
    step = spec._score_step
    spec._score_step = lambda *a: (lambda r, c: (r * float("nan"), c))(
        *step(*a))
    server.submit(tserve.Request(**req))
    assert server.run() == []
    assert [r.rid for r in server.failed] == [0]
    assert server.failed[0].error == ("retries exhausted (1) after "
                                      "non-finite verify logits")
    assert server.failed[0].out == [] and server.aborts == 2
    assert [e for e in server.trace if e[0] == "abort"] == [
        ("abort", 0, 0, "non-finite verify logits")] * 2
    _assert_drained(server)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_spec_flags(capsys):
    base = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit):
        tserve.main(base + ["--spec-ngram"])
    assert "require --paged" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(base + ["--paged", "--spec-ngram", "--spec-draft",
                            "qwen3-moe-30b-a3b"])
    assert "mutually exclusive" in capsys.readouterr().err
    done = tserve.main(base + ["--paged", "--spec-ngram", "--spec-k", "2",
                               "--slots", "2", "--requests", "3",
                               "--max-new", "6", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out) == 6 for r in done)
    assert "leak-free=True" in out and "[serve] speculative:" in out
    # a dense-FFN draft model: speculation keeps the plain engine's streams
    args = ["--paged", "--slots", "2", "--requests", "3", "--max-new", "6",
            "--max-seq", "32"]
    plain = tserve.main(base + args)
    drafted = tserve.main(base + args + ["--spec-draft", "gemma-2b"])
    out = capsys.readouterr().out
    assert [r.out for r in drafted] == [r.out for r in plain]
    assert all(len(r.out) == 6 for r in drafted)
    assert "[serve] speculative:" in out and "leak-free=True" in out
