"""PyTorch port vs the JAX package: the quantized serving path (block-wise
int8/fp8 expert weights, int8 paged KV pools).

The JAX ``PagedServer`` (Pallas kernels in interpret mode, blk 8) and the
port's on the CPU serve the same requests from the same weights: the JAX
tree quantized by ``repro.quant.quantize_lm_params`` and carried over by
``params_from_jax`` (int8/fp8 payloads and ``<name>_scale`` leaves). The
greedy streams must be token-identical, every chunk's prefill logits
within 1e-4 (f32 smoke configs), the page bytes equal and the pool
leak-free. The int8 page bytes and cache layout, the carry-over, the
port's own per-layer quantization, one decode step's quantized KV writes
and the CLI's ``--quant``/``--kv-quant`` are checked on their own."""
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
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.quant import core as tq

# Tiny shapes: one intra-op thread, so idle OpenMP workers do not spin on
# the cores the other test processes use.
torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
NUM_SLOTS, PAGE, MAXP, CHUNK, N_REQ = 3, 4, 8, 5, 6
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _configs(arch=ARCH, dtype="float32"):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tcfglib.get_smoke_config(arch), dtype=dtype))


def _params(cfg_j, cfg_t, quant, seed=0):
    """The JAX tree (quantized by the JAX walker unless quant is "none")
    and its carry-over."""
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(seed), cfg_j))
    if quant != "none":
        pj = jq.quantize_lm_params(pj, cfg_j, mode=quant)
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), cfg_t,
                               device="cpu")


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1
                else a.float()).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.astype(np.float32)


def _record(server, sink):
    step = server.prefill_step

    def wrapped(*args):
        out = step(*args)
        sink.append(np.asarray(out[0], np.float32).reshape(-1))
        return out

    server.prefill_step = wrapped


@pytest.mark.parametrize("quant,kv_quant", [("int8", "int8"), ("fp8", "int8"),
                                            ("int8", "none"),
                                            ("none", "int8")])
def test_quantized_paged_server_matches_jax(quant, kv_quant):
    cfg_j, cfg_t = _configs()
    pj, pt = _params(cfg_j, cfg_t, quant)
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(N_REQ):
        plen = int(rng.integers(2, 14))
        reqs.append((i, rng.integers(0, cfg_j.vocab_size, size=plen).astype(
            np.int32), int(rng.integers(1, 6))))
    kw = dict(num_slots=NUM_SLOTS, page_size=PAGE,
              num_pages=1 + NUM_SLOTS * MAXP, max_pages_per_slot=MAXP,
              prefill_chunk=CHUNK, kv_quant=kv_quant)
    js = jserve.PagedServer(cfg_j, JPC(blk=8, impl="pallas"), None,
                            params=pj, **kw)
    ts = tserve.PagedServer(cfg_t, TPC(blk=8), params=pt, device="cpu", **kw)
    if kv_quant == "int8":
        layer = ts.cache["layers"][0]
        assert layer["k"].dtype == torch.int8
        assert layer["k_scale"].shape == layer["k"].shape[:3]
    assert ts.page_bytes == js.page_bytes
    j_logits, t_logits = [], []
    _record(js, j_logits)
    _record(ts, t_logits)
    for rid, prompt, max_new in reqs:
        js.submit(jserve.Request(rid=rid, prompt=prompt, max_new=max_new))
        ts.submit(tserve.Request(rid=rid, prompt=prompt, max_new=max_new))
    jdone = {r.rid: r.out for r in js.run()}
    tdone = {r.rid: r.out for r in ts.run()}

    assert ts.admissions > NUM_SLOTS, "no mid-run slot refill happened"
    assert len(tdone) == N_REQ and tdone == jdone
    assert len(t_logits) == len(j_logits) > N_REQ
    for got, want in zip(t_logits, j_logits):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    ts.pool.assert_consistent()
    assert ts.pool.free_pages == NUM_SLOTS * MAXP
    assert ts.stats()["total_allocs"] == js.pool.stats()["total_allocs"]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
@pytest.mark.parametrize("kv_quant", [None, "none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoke", [True, False])
def test_page_bytes_and_cache_layout_match_jax(arch, kv_quant, dtype, smoke):
    """An int8 K or V row costs Hkv * (hd + 4) bytes; the pools and their
    scale pools have the JAX layout less its period axis."""
    get_j = jcfglib.get_smoke_config if smoke else jcfglib.get_config
    get_t = tcfglib.get_smoke_config if smoke else tcfglib.get_config
    cfg_j = dataclasses.replace(get_j(arch), dtype=dtype)
    cfg_t = dataclasses.replace(get_t(arch), dtype=dtype)
    assert tlm.paged_kv_page_bytes(cfg_t, 16, kv_quant=kv_quant) == \
        jlm.paged_kv_page_bytes(cfg_j, 16, kv_quant=kv_quant)
    if kv_quant == "int8":
        assert tlm.paged_kv_page_bytes(cfg_t, 16, kv_quant="int8") == (
            cfg_t.num_layers * 2 * 16 * cfg_t.num_kv_heads * (cfg_t.hd + 4))
    jspec = jlm.paged_cache_spec(cfg_j, 3, 7, 16, kv_quant=kv_quant)
    tspec = tlm.paged_cache_spec(cfg_t, 3, 7, 16, kv_quant=kv_quant)
    assert len(tspec["layers"]) == cfg_t.num_layers
    for li, layer in enumerate(tspec["layers"]):
        want = jspec["layers"][li % cfg_j.period]
        assert set(layer) == set(want)
        for k, (shape, dt) in layer.items():
            assert shape == tuple(want[k].shape[1:])
            assert str(dt).split(".")[-1] == str(want[k].dtype)
    assert tspec["len"][0] == tuple(jspec["len"].shape)
    if smoke and dtype == "float32":
        cache = tlm.init_paged_cache(cfg_t, 3, 7, 16, "cpu",
                                     kv_quant=kv_quant)
        for layer in cache["layers"]:
            assert all(not t.any() for t in layer.values())
    with pytest.raises(ValueError):
        tlm.paged_kv_page_bytes(cfg_t, 16, kv_quant="fp8")


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_params_carry_over_and_match_port_walker(quant):
    """``params_from_jax`` carries the JAX walker's payloads and scales bit
    for bit; the port's own walker (in place) and ``init_params(quant=)``
    give the same as the JAX walker on the same weights."""
    cfg_j, cfg_t = _configs(dtype="bfloat16")
    pj, pt = _params(cfg_j, cfg_t, quant, seed=2)
    _, plain = _params(cfg_j, cfg_t, "none", seed=2)
    layers = plain["layers"]
    walked = tq.quantize_lm_params(plain, cfg_t, mode=quant)
    assert walked is plain and walked["layers"] is layers   # in place
    fmt = tq.QUANT_FORMATS[quant][0]
    for li in range(cfg_t.num_layers):
        ffn_t, ffn_w = pt["layers"][li]["ffn"], walked["layers"][li]["ffn"]
        assert set(ffn_t) == set(ffn_w) == set(EXPERT_KEYS) | {
            f"{k}_scale" for k in EXPERT_KEYS} | {"router"}
        for name, t in ffn_t.items():
            want = np.asarray(pj["layers"][0]["ffn"][name][li])
            np.testing.assert_array_equal(_bits(t), _bits(want))
            np.testing.assert_array_equal(_bits(ffn_w[name]), _bits(t))
            if name in EXPERT_KEYS:
                assert t.dtype == fmt
            elif name.endswith("_scale"):
                assert t.dtype == torch.float32
    # drawn and quantized layer by layer == drawn, then walked
    a = tlm.init_params(cfg_t, generator=torch.Generator().manual_seed(3),
                        device="cpu", quant=quant)
    b = tq.quantize_lm_params(tlm.init_params(
        cfg_t, generator=torch.Generator().manual_seed(3), device="cpu"),
        cfg_t, mode=quant)
    from repro_torch.common import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.uint8)
                                                  if x.element_size() == 1
                                                  else x, y.view(torch.uint8)
                                                  if y.element_size() == 1
                                                  else y)


def test_decode_step_writes_quantized_rows_like_jax():
    """One f32 decode forward over random int8 pools: logits within 1e-4,
    the lengths equal, and each written row's int8 codes within one code
    of JAX's (K/V are f32 products summed in another order, so a value on
    a rounding boundary may land a code apart) and its scale within 1e-5."""
    cfg_j, cfg_t = _configs()
    pj, pt = _params(cfg_j, cfg_t, "int8", seed=1)
    b, npages = 3, 1 + 3 * MAXP
    rng = np.random.default_rng(0)
    shape = (cfg_j.num_layers, npages, PAGE, cfg_j.num_kv_heads, cfg_j.hd)
    rows = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    pools = {}
    for k, v in rows.items():
        q, s = jq.quantize_rows(jnp.asarray(v))
        pools[k], pools[f"{k}_scale"] = np.asarray(q), np.asarray(s)
    table = (1 + np.arange(b * MAXP)).reshape(b, MAXP).astype(np.int32)
    lengths = np.array([5, 0, 13], np.int32)
    active = np.array([True, False, True])
    tokens = rng.integers(0, cfg_j.vocab_size, size=(b, 1)).astype(np.int32)

    jcache = {"layers": [{k: jnp.asarray(v) for k, v in pools.items()}],
              "len": jnp.asarray(lengths)}
    jstep = jsteps.make_paged_serve_step(cfg_j, JPC(blk=8, impl="pallas"),
                                         None, (b, 1, cfg_j.d_model), PAGE)
    jlogits, jnew = jstep(pj, {"tokens": jnp.asarray(tokens),
                               "page_table": jnp.asarray(table),
                               "active": jnp.asarray(active)}, jcache)
    tcache = {"layers": [{k: torch.from_numpy(v[i].copy())
                          for k, v in pools.items()}
                         for i in range(cfg_t.num_layers)],
              "len": torch.from_numpy(lengths)}
    tstep = tsteps.make_paged_serve_step(cfg_t, TPC(blk=8), PAGE)
    tlogits, tnew = tstep(pt, {"tokens": torch.from_numpy(tokens),
                               "page_table": torch.from_numpy(table),
                               "active": torch.from_numpy(active)}, tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tnew["len"].numpy(),
                                  np.asarray(jnew["len"]))
    for i in range(cfg_t.num_layers):
        for k in "kv":
            got = tnew["layers"][i][k].numpy().astype(np.int32)
            want = np.asarray(jnew["layers"][0][k][i]).astype(np.int32)
            assert np.abs(got - want).max() <= 1
            assert (got != pools[k][i]).any(), "no row was written"
            np.testing.assert_allclose(
                tnew["layers"][i][f"{k}_scale"].numpy(),
                np.asarray(jnew["layers"][0][f"{k}_scale"][i]), rtol=1e-5,
                atol=0)


def test_cli_serves_quantized_on_cpu(capsys):
    done = tserve.main(["--arch", ARCH, "--smoke", "--paged", "--device",
                        "cpu", "--slots", "2", "--requests", "3",
                        "--max-new", "3", "--max-seq", "32", "--quant",
                        "int8", "--kv-quant", "int8"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    out = capsys.readouterr().out
    assert "[serve] expert weights -> int8" in out
    assert "B a int8 page" in out and "leak-free=True" in out
    cfg = tcfglib.get_smoke_config(ARCH)
    assert f"{tlm.paged_kv_page_bytes(cfg, 16, 'int8')} B a int8 page" in out
    with pytest.raises(SystemExit):             # argparse: --paged needed
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--kv-quant", "int8"])
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--smoke", "--paged", "--device", "cpu",
                     "--quant", "int4"])
