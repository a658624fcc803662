"""PyTorch port vs the JAX package: the paged serving slice as a whole.

The JAX ``PagedServer`` (Pallas kernels in interpret mode, blk 8) and the
port's ``PagedServer`` on the CPU serve the same requests from the same
weights (carried over by ``params_from_jax``) on the f32 smoke configs,
with more requests than slots so slots refill mid-run, and past the
sliding window on gemma3-12b's and mixtral-8x7b's (int8 experts). Greedy
streams must be token-identical (the port's dense engine's too), the
scheduler traces equal, every prefill chunk's and decode step's logits
within 1e-4, and the page pool leak-free. One bf16 decode forward is compared on its own, and the
CLI's contract (the dense engine without ``--paged``, sampled requests
served, GPU unless asked) is checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro.quant import core as jq
from repro_torch import common as tcommon
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.parallel.sharding import ParallelConfig as TPC

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

NUM_SLOTS, PAGE, MAXP, CHUNK, N_REQ = 3, 4, 8, 5, 6


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tcfglib.get_smoke_config(arch), dtype=dtype))


def _params(cfg_j, cfg_t, seed=0):
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(seed), cfg_j))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), cfg_t,
                               device="cpu")


def _requests(vocab, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(2, 14))
        out.append((i, rng.integers(0, vocab, size=plen).astype(np.int32),
                    int(rng.integers(1, 6))))
    return out


def _record(server, sink):
    """Every prefill chunk's and decode step's logits, in call order."""
    for name in ("prefill_step", "serve_step"):
        step = getattr(server, name)

        def wrapped(*args, _step=step):
            out = _step(*args)
            sink.append(np.asarray(out[0], np.float32).reshape(-1))
            return out

        setattr(server, name, wrapped)


# (arch, expert weights, prompt lengths, slots, max pages a slot, prefill
# chunk). The random mixes refill slots mid-run; the window crossings
# (gemma3-12b's and mixtral-8x7b's smoke window is 16 rows) send 3
# requests to 2 slots, the first two prompts past the window, in chunks
# that do not divide it, mixtral-8x7b's experts int8.
PAGED_CASES = [
    ("qwen3-moe-30b-a3b", "none", None, NUM_SLOTS, MAXP, CHUNK),
    ("mixtral-8x7b", "none", None, NUM_SLOTS, MAXP, CHUNK),
    ("gemma3-12b", "none", (37, 21, 5), 2, 16, 7),
    ("mixtral-8x7b", "int8", (41, 23, 6), 2, 16, 7),
]


@pytest.mark.parametrize("arch,quant,lengths,slots,maxp,chunk", PAGED_CASES,
                         ids=["qwen3-moe-30b-a3b", "mixtral-8x7b",
                              "gemma3-12b-past-window",
                              "mixtral-8x7b-int8-past-window"])
def test_paged_server_matches_jax(arch, quant, lengths, slots, maxp, chunk):
    cfg_j, cfg_t = _configs(arch)
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    if quant != "none":
        pj = jq.quantize_lm_params(pj, cfg_j, mode=quant)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    if lengths is None:
        reqs = _requests(cfg_j.vocab_size)
    else:
        assert cfg_t.window == 16 and cfg_t.window % chunk
        assert max(lengths) > cfg_t.window
        assert pt["layers"][0]["ffn"]["w_up"].dtype == (
            torch.int8 if quant == "int8" else torch.float32)
        rng = np.random.default_rng(19)
        reqs = [(i, rng.integers(0, cfg_t.vocab_size, size=n).astype(
            np.int32), int(rng.integers(6, 10))) for i, n in
            enumerate(lengths)]
    kw = dict(num_slots=slots, page_size=PAGE, num_pages=1 + slots * maxp,
              max_pages_per_slot=maxp, prefill_chunk=chunk)

    js = jserve.PagedServer(cfg_j, JPC(blk=8, impl="pallas"), None,
                            params=pj, **kw)
    ts = tserve.PagedServer(cfg_t, TPC(blk=8), params=pt, device="cpu", **kw)
    dense = tserve.BatchedServer(cfg_t, TPC(blk=8), num_slots=slots,
                                 max_seq=PAGE * maxp, params=pt,
                                 device="cpu")
    j_logits, t_logits = [], []
    _record(js, j_logits)
    _record(ts, t_logits)
    for rid, prompt, max_new in reqs:
        js.submit(jserve.Request(rid=rid, prompt=prompt, max_new=max_new))
        ts.submit(tserve.Request(rid=rid, prompt=prompt, max_new=max_new))
        dense.submit(tserve.Request(rid=rid, prompt=prompt, max_new=max_new))
    jdone = {r.rid: r.out for r in js.run()}
    tdone = {r.rid: r.out for r in ts.run()}

    assert ts.admissions > slots, "no mid-run slot refill happened"
    assert len(tdone) == len(reqs)
    assert tdone == jdone
    assert ts.trace == js.trace and ts.stats() == js.stats()
    assert len(t_logits) == len(j_logits) > len(reqs)  # multi-chunk prompts
    for got, want in zip(t_logits, j_logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the dense engine (its rolling window buffer past the window) too
    assert {r.rid: r.out for r in dense.run()} == tdone
    ts.pool.assert_consistent()
    assert ts.pool.free_pages == slots * maxp
    assert ts.pool.in_use_pages == 0 and (ts.table == 0).all()
    assert ts.stats()["total_allocs"] == js.pool.stats()["total_allocs"]
    if lengths is not None:
        # every layer windowed: the pages wholly behind the window were
        # handed back while the long requests decoded
        assert (ts.reclaim_window == cfg_t.window) == (arch == "mixtral-8x7b")


def test_decode_forward_bf16_matches_jax():
    """One bf16 decode forward over random page pools: logits (up to ~0.5)
    within atol 2e-2 — bf16 activations round at every matmul, norm and
    residual add in both packages, in different orders (4.5e-3 seen) — and
    the new K/V rows land on the same pages within bf16 rounding."""
    cfg_j, cfg_t = _configs("qwen3-moe-30b-a3b", "bfloat16")
    pj, pt = _params(cfg_j, cfg_t, seed=1)
    b, npages = 3, 1 + 3 * MAXP
    rng = np.random.default_rng(0)
    shape = (cfg_j.num_layers, npages, PAGE, cfg_j.num_kv_heads, cfg_j.hd)
    pools = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    table = (1 + np.arange(b * MAXP)).reshape(b, MAXP).astype(np.int32)
    lengths = np.array([5, 0, 13], np.int32)
    active = np.array([True, False, True])
    tokens = rng.integers(0, cfg_j.vocab_size, size=(b, 1)).astype(np.int32)

    jcache = {"layers": [{k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in pools.items()}],
              "len": jnp.asarray(lengths)}
    jstep = jsteps.make_paged_serve_step(cfg_j, JPC(blk=8, impl="pallas"),
                                         None, (b, 1, cfg_j.d_model), PAGE)
    jlogits, jnew = jstep(pj, {"tokens": jnp.asarray(tokens),
                               "page_table": jnp.asarray(table),
                               "active": jnp.asarray(active)}, jcache)

    tcache = {"layers": [{k: torch.from_numpy(v[i]).bfloat16()
                          for k, v in pools.items()}
                         for i in range(cfg_t.num_layers)],
              "len": torch.from_numpy(lengths)}
    tstep = tsteps.make_paged_serve_step(cfg_t, TPC(blk=8), PAGE)
    tlogits, tnew = tstep(pt, {"tokens": torch.from_numpy(tokens),
                               "page_table": torch.from_numpy(table),
                               "active": torch.from_numpy(active)}, tcache)

    assert tlogits.dtype == torch.float32 and tlogits.shape == jlogits.shape
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=2e-2)
    np.testing.assert_array_equal(tnew["len"].numpy(),
                                  np.asarray(jnew["len"]))
    for i in range(cfg_t.num_layers):
        for k in "kv":
            want = np.asarray(jnew["layers"][0][k][i].astype(jnp.float32))
            np.testing.assert_allclose(tnew["layers"][i][k].float().numpy(),
                                       want, rtol=2e-2, atol=2e-2)


def test_params_from_jax_carries_every_leaf():
    cfg_j, cfg_t = _configs("qwen3-moe-30b-a3b", "bfloat16")
    pj, pt = _params(cfg_j, cfg_t, seed=2)
    own = tlm.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert len(pt["layers"]) == cfg_t.num_layers
    for li, layer in enumerate(pt["layers"]):
        for name, sub in layer.items():
            for leaf, t in sub.items():
                want = np.asarray(pj["layers"][0][name][leaf][li])
                assert t.dtype == own["layers"][li][name][leaf].dtype
                assert t.shape == own["layers"][li][name][leaf].shape
                np.testing.assert_array_equal(
                    t.float().numpy(), want.astype(np.float32))
    for key in ("embed", "head"):
        assert pt[key].dtype == torch.bfloat16
        assert pt[key].shape == own[key].shape == pj[key].shape
    assert abs(float(own["embed"].float().std()) - 0.02) < 2e-3


def test_cli_serves_paged_on_cpu(capsys):
    done = tserve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--paged",
                        "--device", "cpu", "--slots", "2", "--requests", "3",
                        "--max-new", "3", "--max-seq", "32"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "leak-free=True" in capsys.readouterr().out


def test_cli_and_engine_contract(monkeypatch, capsys):
    # without --paged the CLI serves through the dense BatchedServer
    done = tserve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                        "--device", "cpu", "--slots", "2", "--requests", "3",
                        "--max-new", "3", "--max-seq", "32"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out
    cfg_j, cfg_t = _configs("qwen3-moe-30b-a3b")
    _, pt = _params(cfg_j, cfg_t)
    server = tserve.PagedServer(cfg_t, TPC(blk=8), num_slots=2, page_size=4,
                                num_pages=9, max_pages_per_slot=4, params=pt,
                                device="cpu")
    # a sampled request is served, its stream the batch-1 reference's
    sampled = dict(rid=0, prompt=np.arange(3), max_new=2, temperature=0.7,
                   seed=5)
    server.submit(tserve.Request(**sampled))
    assert [r.out for r in server.run()] == [tserve.reference_stream(
        cfg_t, TPC(blk=8), pt, tserve.Request(**sampled), max_seq=16)]
    with pytest.raises(ValueError):
        server.submit(tserve.Request(rid=1, prompt=np.arange(20), max_new=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--paged"])


def test_page_pool_matches_jax():
    """The same reserve/alloc/release sequence on both pools hands out the
    same page ids and keeps the same books."""
    from repro.parallel.cache import PagePool as JPool
    from repro_torch.parallel.cache import PagePool as TPool

    rng = np.random.default_rng(5)
    jp, tp = JPool(17, page_bytes=64), TPool(17, page_bytes=64)
    held = []                     # (pages, reserved, allocated) per request
    for _ in range(200):
        op = rng.integers(3)
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
        elif held:
            pages, res, alloc = held.pop(int(rng.integers(len(held))))
            jp.release(pages, unused_reserved=res - alloc)
            tp.release(pages, unused_reserved=res - alloc)
        tp.assert_consistent()
        want = jp.stats()
        assert tp.stats() == {k: want[k] for k in tp.stats()}
    with pytest.raises(RuntimeError):
        tp.release([int(tp._free_list[0])])
