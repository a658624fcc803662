"""PyTorch port vs the JAX package: the prefix-sharing paged engine.

The JAX ``PagedServer`` (Pallas in interpret mode, blk 8) and the port's
serve the same requests from the same weights (``params_from_jax``) on
qwen3-moe-30b-a3b's smoke config (2 layers), 3 slots, 4-token pages,
chunks of 5, and the two engines must agree on everything observable:
the streams, the whole scheduler ``trace`` (admissions, prefill chunks,
decode steps, transfers, finishes, rollbacks, verify rounds), the pool's
and the prefix index's counters, the roles and transfers:

* the prefix cache on a shared system prompt, in f32 and bf16 and over
  int8 KV pages, against the engine without it and the batch-1
  reference (f32); and under eviction pressure (a pool too small to keep
  every prompt family cached);
* speculation (``NGramDrafter``) on top of prefix hits, audited after
  every step;
* a forced copy-on-write: another holder forks the page a decode step is
  about to write, so ``_cow_page`` copies it (``make_page_copy_step``)
  and the shared page keeps its rows;
* ``make_page_copy_step`` and ``make_paged_handoff_step`` against JAX's on
  random f32, bf16 and int8 pools;
* disaggregated roles: half/half strict roles with one transfer a
  request, a uniform plan's degenerate case (its trace the single-loop
  engine's), a skewed plan (``token_counts`` (2, 1));
* the constructor's and ``submit``'s validation errors, and the CLI's
  ``--prefix-cache``/``--disagg``/``--audit`` on the CPU.

Streams and traces are compared exactly. The f32 prefix-cache streams must
equal the batch-1 reference as in the JAX suite; bf16 streams are compared
between the packages (the same decisions on the same bf16 weights) and
with the cache off. Pages: the CoW copy's f32 rows within 1e-5 x max|ref|
of JAX's (summation order of the rows written); the copy and handoff
steps exactly, in every dtype.
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
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro.runtime import faults as jfaults
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import spec as tspec
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.runtime import faults as tfaults

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
JPCFG = JPC(blk=8, impl="pallas")
TPCFG = TPC(blk=8)
MAX_SEQ, NUM_SLOTS, PAGE, CHUNK, N_REQ = 32, 3, 4, 5, 6
MAXP = MAX_SEQ // PAGE

_MODELS: dict = {}


def _models(dtype="float32", arch=ARCH):
    """(cfg_j, cfg_t, params_j, params_t) from PRNGKey(0), built once."""
    if (dtype, arch) not in _MODELS:
        cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                    dtype=dtype)
        cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                    dtype=dtype)
        pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
        _MODELS[dtype, arch] = (cfg_j, cfg_t, pj, params_from_jax(
            jax.tree.map(np.asarray, pj), cfg_t, device="cpu"))
    return _MODELS[dtype, arch]


def _shared_prefix_requests(vocab, n, seed, shared_len=12):
    """Every request opens with one ``shared_len``-token system prompt and
    appends a short tail of its own (``tests/test_serve_parity.py``'s
    chat-style workload)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    return [dict(rid=i, prompt=np.concatenate([shared, rng.integers(
        0, vocab, size=int(rng.integers(1, 4))).astype(np.int32)]),
        max_new=int(rng.integers(2, 6))) for i in range(n)]


def _serve(pkg, reqs, *, dtype="float32", arch=ARCH, drafter=None,
           spec_k=3, num_slots=NUM_SLOTS, num_pages=None, faults=(), **kw):
    """Serve ``reqs`` (dicts) on the JAX (``pkg == "jax"``) or the port's
    engine, under a fault plan of that package built from ``faults``
    (``Fault`` field dicts; the plan is left as ``server.fault_plan``);
    returns (server, {rid: stream})."""
    cfg_j, cfg_t, pj, pt = _models(dtype, arch)
    common = dict(num_slots=num_slots, page_size=PAGE,
                  num_pages=num_pages or 1 + num_slots * MAXP,
                  max_pages_per_slot=MAXP, prefill_chunk=CHUNK)
    common.update(kw)
    if isinstance(common.get("clock"), type):     # a clock an engine
        common["clock"] = common["clock"]()
    if pkg == "jax":
        srv = jserve.PagedServer(cfg_j, JPCFG, None, params=pj, **common)
        if drafter is not None:
            jspec.SpecDecoder(srv, drafter, k=spec_k)
        req_cls, fl = jserve.Request, jfaults
    else:
        srv = tserve.PagedServer(cfg_t, TPCFG, params=pt, device="cpu",
                                 **common)
        if drafter is not None:
            tspec.SpecDecoder(srv, drafter, k=spec_k)
        req_cls, fl = tserve.Request, tfaults
    for r in reqs:
        srv.submit(req_cls(**r))
    srv.fault_plan = fl.FaultPlan([fl.Fault(**f) for f in faults])
    with fl.scope(srv.fault_plan):
        done = srv.run()
    return srv, {r.rid: r.out for r in done}


def _both(reqs, *, drafter=None, **kw):
    """The same workload on both engines; everything observable equal.
    ``drafter``: a zero-argument factory (one drafter an engine)."""
    jsrv, jout = _serve("jax", reqs, drafter=drafter and drafter("jax"),
                        **kw)
    tsrv, tout = _serve("torch", reqs, drafter=drafter and drafter("torch"),
                        **kw)
    assert tout == jout
    assert tsrv.trace == jsrv.trace
    assert tsrv.stats() == jsrv.stats()
    assert tsrv.roles == jsrv.roles and tsrv.groups == jsrv.groups
    assert [(r.rid, r.error) for r in tsrv.failed] == \
        [(r.rid, r.error) for r in jsrv.failed]
    if tsrv.spec is not None:
        assert tsrv.spec.stats() == jsrv.spec.stats()
    assert tsrv.fault_plan.fired == jsrv.fault_plan.fired
    return jsrv, tsrv, tout


def _drained(srv):
    srv.assert_page_invariants()
    srv.drop_prefix_cache()
    srv.pool.assert_consistent()
    assert srv.pool.free_pages == sum(srv.pool.shares)
    assert srv.pool.in_use_pages == srv.pool.reserved_pages == 0
    assert (srv.table == 0).all()


def _references(reqs, dtype="float32", arch=ARCH):
    _, cfg_t, _, pt = _models(dtype, arch)
    step = tsteps.make_serve_step(cfg_t, TPCFG)
    return {r["rid"]: tserve.reference_stream(
        cfg_t, TPCFG, pt, tserve.Request(**r), max_seq=MAX_SEQ, step=step)
        for r in reqs}


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kv_quant", [("float32", None),
                                            ("float32", "int8"),
                                            ("bfloat16", None)])
def test_prefix_cache_matches_jax(dtype, kv_quant):
    """Cache on == off (== the batch-1 reference in f32), the same
    schedule, hits and pages as JAX's engine; fewer allocations and
    prefill chunks with the cache; a drained pool once the index drops."""
    _, cfg_t, _, _ = _models(dtype)
    reqs = _shared_prefix_requests(cfg_t.vocab_size, N_REQ, seed=29)
    jsrv, tsrv, out_on = _both(reqs, dtype=dtype, kv_quant=kv_quant,
                               prefix_cache=True, audit=True)
    off, out_off = _serve("torch", reqs, dtype=dtype, kv_quant=kv_quant)
    assert out_on == out_off
    if dtype == "float32" and kv_quant is None:
        assert out_on == _references(reqs)
    pf = tsrv.stats()["prefix"]
    assert pf["hit_tokens"] > 0 and tsrv.pool.total_forks > 0
    assert tsrv.pool.total_allocs < off.pool.total_allocs
    chunks = [sum(e[0] == "prefill_chunk" for e in s.trace)
              for s in (tsrv, off)]
    assert chunks[0] < chunks[1]
    if kv_quant:
        assert tsrv.cache["layers"][0]["k"].dtype == torch.int8
    _drained(tsrv)
    _drained(jsrv)


def test_prefix_cache_under_eviction_pressure_matches_jax():
    """Three 8-token prompt families revisited out of order through a pool
    that cannot keep them all cached: admission evicts LRU trie pages."""
    _, cfg_t, _, _ = _models()
    rng = np.random.default_rng(37)
    fams = [rng.integers(0, cfg_t.vocab_size, size=8).astype(np.int32)
            for _ in range(3)]
    reqs = [dict(rid=i, prompt=np.concatenate([fams[f], rng.integers(
        0, cfg_t.vocab_size, size=2).astype(np.int32)]), max_new=3)
        for i, f in enumerate([0, 1, 2, 0, 1, 2, 2, 0])]
    jsrv, tsrv, out = _both(reqs, num_slots=2, num_pages=8,
                            prefix_cache=True, audit=True)
    assert out == _references(reqs)
    assert tsrv.stats()["prefix"]["evictions"] > 0
    _drained(tsrv)


def test_spec_on_prefix_hits_matches_jax():
    """Speculation on top of prefix hits: rollback pops decode pages only,
    never a shared prompt page (the pool would raise), and the verify
    rounds, acceptances and rollbacks are JAX's."""
    _, cfg_t, _, _ = _models()
    reqs = _shared_prefix_requests(cfg_t.vocab_size, N_REQ, seed=61)
    for r in reqs:
        r["max_new"] = max(r["max_new"], 3)
    drafter = {"jax": jspec.NGramDrafter, "torch": tspec.NGramDrafter}
    jsrv, tsrv, out = _both(reqs, drafter=lambda pkg: drafter[pkg](),
                            prefix_cache=True, audit=True)
    assert out == _references(reqs)
    assert tsrv.stats()["prefix"]["hit_tokens"] > 0
    assert any(e[0] == "rollback" for e in tsrv.trace)
    _drained(tsrv)


def _fork_before_decode(srv, held: list):
    """Before the first decode tick where a decoding slot's next row lands
    in a page it already holds, fork that page once (a holder outside the
    engine), so the tick's ``_ensure_pages`` must copy it."""
    tick = srv._decode_tick

    def decode(done):
        cand = [(s, st) for s, st in enumerate(srv.slots)
                if st is not None and st.pos >= len(st.req.prompt)
                and st.length % PAGE]
        if cand and not held:
            slot, st = cand[0]
            page = st.pages[st.length // PAGE]
            srv.pool.fork([page])
            held.append((slot, page))
        return tick(done)

    srv._decode_tick = decode


def test_forced_cow_copies_the_page_as_jax_does():
    _, cfg_t, _, _ = _models()
    reqs = [dict(rid=i, prompt=np.arange(3 + 4 * i, dtype=np.int32) % 100,
                 max_new=5) for i in range(3)]
    plain, want = _serve("torch", reqs)
    servers, outs, holds = [], [], []
    for pkg in ("jax", "torch"):
        held: list = []
        cfg = _models()[0 if pkg == "jax" else 1]
        kw = dict(num_slots=NUM_SLOTS, page_size=PAGE, num_pages=1 + 3 * MAXP,
                  max_pages_per_slot=MAXP, prefill_chunk=CHUNK)
        if pkg == "jax":
            srv = jserve.PagedServer(cfg, JPCFG, None, params=_models()[2],
                                     **kw)
            req_cls = jserve.Request
        else:
            srv = tserve.PagedServer(cfg, TPCFG, params=_models()[3],
                                     device="cpu", **kw)
            req_cls = tserve.Request
        _fork_before_decode(srv, held)
        for r in reqs:
            srv.submit(req_cls(**r))
        outs.append({r.rid: r.out for r in srv.run()})
        servers.append(srv)
        holds.append(held)
    jsrv, tsrv = servers
    assert outs[0] == outs[1] == want
    assert holds[0] == holds[1] and len(holds[1]) == 1
    assert tsrv.trace == jsrv.trace == plain.trace
    assert tsrv.pool.stats() == jsrv.pool.stats()
    assert tsrv.pool.total_cow_copies == 1
    (_, page), = holds[1]
    assert tsrv.pool.refcount(page) == 1           # the outside holder's
    for i, tl in enumerate(tsrv.cache["layers"]):
        for name in ("k", "v"):
            j = np.asarray(jsrv.cache["layers"][0][name][i, page])
            np.testing.assert_allclose(tl[name][page].numpy(), j, rtol=0,
                                       atol=1e-5 * float(np.abs(j).max()))
    tsrv.pool.release([page])
    jsrv.pool.release([page])
    _drained(tsrv)


@pytest.mark.parametrize("dtype,kv_quant", [("float32", None),
                                            ("bfloat16", None),
                                            ("float32", "int8")])
def test_page_copy_and_handoff_steps_match_jax(dtype, kv_quant):
    cfg_j, cfg_t, _, _ = _models(dtype)
    npages, slots = 7, 3
    jcache = jlm.init_paged_cache(cfg_j, slots, npages, PAGE,
                                  kv_quant=kv_quant)
    rng = np.random.default_rng(3)
    jcache = jax.tree.map(
        lambda a: jnp.asarray((rng.normal(size=a.shape) * 50).astype(
            a.dtype) if a.dtype != jnp.int32 else rng.integers(
                0, 20, size=a.shape).astype(np.int32)), jcache)
    tcache = tlm.init_paged_cache(cfg_t, slots, npages, PAGE, "cpu",
                                  kv_quant=kv_quant)
    tcache["len"].copy_(torch.from_numpy(np.array(jcache["len"])))
    for i, tl in enumerate(tcache["layers"]):
        jl = jcache["layers"][0]            # (n_periods, pages, ...)
        for name, t in tl.items():
            t.copy_(torch.from_numpy(np.array(
                jl[name][i].astype(jnp.float32))).to(t.dtype))
    jcache = jsteps.make_page_copy_step(cfg_j)(jcache, jnp.int32(2),
                                               jnp.int32(5))
    tcache = tsteps.make_page_copy_step(cfg_t)(tcache, 2, 5)
    jcache = jsteps.make_paged_handoff_step(cfg_j)(jcache, jnp.int32(0),
                                                   jnp.int32(2))
    tcache = tsteps.make_paged_handoff_step(cfg_t)(tcache, 0, 2)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    assert tcache["len"][0] == 0
    names = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    for i, tl in enumerate(tcache["layers"]):
        assert sorted(tl) == sorted(names)
        for name in names:
            want = np.asarray(jcache["layers"][0][name][i].astype(
                jnp.float32))
            got = tl[name].float().numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got[5], got[2])


# ---------------------------------------------------------------------------
# disaggregated roles
# ---------------------------------------------------------------------------

def _requests(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(2, 12))).astype(np.int32),
        max_new=int(rng.integers(2, 6))) for i in range(n)]


def test_disagg_strict_roles_match_jax():
    """Half/half roles: every request hands off exactly once, prefill
    chunks only on prefill slots, decode steps only on decode slots, and
    the streams are the single-loop engine's."""
    _, cfg_t, _, _ = _models()
    reqs = _requests(cfg_t.vocab_size, N_REQ, seed=13)
    _, tsrv, out = _both(reqs, num_slots=4, disagg=True, audit=True)
    _, single = _serve("torch", reqs, num_slots=4)
    assert out == single
    roles = tsrv.roles
    assert roles == ["prefill", "prefill", "decode", "decode"]
    assert tsrv.transfers == len(reqs)
    moved = set()
    for ev in tsrv.trace:
        if ev[0] == "prefill_chunk":
            assert roles[ev[2]] == "prefill", ev
        elif ev[0] == "decode":
            assert all(roles[s] == "decode" for s in ev[1]), ev
        elif ev[0] == "transfer":
            assert roles[ev[2]] == "prefill" and roles[ev[3]] == "decode"
            moved.add(ev[1])
    assert moved == {r["rid"] for r in reqs}
    _drained(tsrv)


def test_disagg_uniform_plan_is_the_single_loop_engine():
    assert tserve.derive_roles((3, 3)) == ["both", "both"]
    assert tserve.derive_roles((5,)) == ["both"]
    assert tserve.derive_roles((4, 2)) == ["prefill", "decode"]
    assert tserve.derive_roles((2, 4, 4)) == ["decode", "prefill", "prefill"]
    _, cfg_t, _, _ = _models()
    reqs = _requests(cfg_t.vocab_size, N_REQ, seed=17)
    plan = SimpleNamespace(token_counts=(2, 2))
    _, tsrv, out = _both(reqs, num_slots=4, plan=plan, disagg=True)
    single, out_single = _serve("torch", reqs, num_slots=4, plan=plan)
    assert tsrv.roles == ["both"] * 4 and tsrv.transfers == 0
    assert out == out_single and tsrv.trace == single.trace


def test_disagg_skewed_plan_matches_jax():
    """token_counts (2, 1): pool shares by Eq. 1, slots 0-1 in group 0
    (prefill), 2-3 in group 1 (decode)."""
    _, cfg_t, _, _ = _models()
    reqs = _requests(cfg_t.vocab_size, N_REQ, seed=19)
    plan = SimpleNamespace(token_counts=(2, 1))
    _, tsrv, out = _both(reqs, num_slots=4, plan=plan, disagg=True,
                         audit=True)
    assert tsrv.roles == ["prefill", "prefill", "decode", "decode"]
    assert tsrv.groups == [0, 0, 1, 1]
    assert tsrv.pool.shares == [21, 11]
    assert tsrv.transfers == len(reqs)
    _, single = _serve("torch", reqs, num_slots=4, plan=plan)
    assert out == single
    _drained(tsrv)


# ---------------------------------------------------------------------------
# validation and the CLI
# ---------------------------------------------------------------------------

def _error(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e), str(e)
    return None


def test_validation_errors_match_jax():
    cfg_j, cfg_t, pj, pt = _models()
    kw = dict(num_slots=1, page_size=PAGE, num_pages=1 + MAXP,
              max_pages_per_slot=MAXP)
    cases = [dict(disagg=True),
             dict(num_slots=1, plan=SimpleNamespace(token_counts=(1, 2))),
             dict(num_slots=2, plan=SimpleNamespace(token_counts=(1, 1)),
                  disagg=True)]
    for extra in cases:
        args = {**kw, **extra}
        want = _error(lambda: jserve.PagedServer(cfg_j, JPCFG, None,
                                                 params=pj, **args))
        got = _error(lambda: tserve.PagedServer(cfg_t, TPCFG, params=pt,
                                                device="cpu", **args))
        assert got == want, extra
    assert _error(lambda: tserve.PagedServer(
        cfg_t, TPCFG, params=pt, device="cpu", **kw, disagg=True))[1] == \
        "disagg needs >= 2 slots"
    plan = SimpleNamespace(token_counts=(3, 1))
    jsrv = jserve.PagedServer(cfg_j, JPCFG, None, params=pj, **{
        **kw, "num_slots": 2, "plan": plan})
    tsrv = tserve.PagedServer(cfg_t, TPCFG, params=pt, device="cpu", **{
        **kw, "num_slots": 2, "plan": plan})
    assert tsrv.pool.shares == jsrv.pool.shares == [6, 2]
    for r in (dict(rid=1, prompt=np.arange(30), max_new=2),    # > share
              dict(rid=2, prompt=np.arange(40), max_new=2),    # > maxp
              dict(rid=3, prompt=np.arange(0), max_new=2)):
        want = _error(lambda: jsrv.submit(jserve.Request(**r)))
        got = _error(lambda: tsrv.submit(tserve.Request(**r)))
        assert got[0] is want[0] is ValueError
        if r["rid"] != 3:
            assert got == want


def test_cli_prefix_disagg_audit(capsys):
    base = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    for flag in (["--prefix-cache"], ["--disagg"], ["--audit"],
                 ["--fault-spec", "{}"]):
        with pytest.raises(SystemExit):
            tserve.main(base + flag)
        assert "require --paged" in capsys.readouterr().err
    done = tserve.main(base + ["--paged", "--prefix-cache", "--disagg",
                               "--audit", "--slots", "4", "--requests", "5",
                               "--max-new", "3", "--max-seq", "32",
                               "--page-size", "4"])
    out = capsys.readouterr().out
    assert len(done) == 5 and all(len(r.out) == 3 for r in done)
    assert "leak-free=True" in out and "[serve] prefix cache:" in out
    assert "[serve] disagg: roles ['prefill', 'prefill', 'decode', " \
           "'decode'], 5 page-table handoffs" in out
