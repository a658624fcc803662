"""PyTorch port vs the JAX package: seeded sampled decoding.

``repro_torch.launch.sampling`` is the port's copy of the ``jax.random``
path the JAX engines sample with (threefry2x32, partitionable counters,
64-bit ints off). Held against ``jax.random`` on the CPU:

- ``threefry2x32``, ``prng_key``, ``fold_in``, the 32-bit bits and the
  uniforms equal bit for bit (seeds 0, 1, 1003, 2**31 - 1, 2**31,
  2**32 + 5 and -1, steps 0-300);
- Gumbel draws within 2 ulp of max(|g|, 1): the two ``log``s of
  ``-log(-log(u))`` each agree within 1 ulp (XLA's against torch's), which
  moves g by at most ulp(1) through the inner one and ulp(g) through the
  outer; near g = 0 an ulp of g itself is far below that;
- ``categorical``, ``next_token`` and ``sample_rows``' tokens equal
  (256 (seed, step) pairs at V 64 and 151,936, temperatures 0.8 and 1.3):
  a token flips only on a near-tie of ``logits / T + g``;
- the sampled streams of the port's ``BatchedServer``, ``PagedServer``
  and ``reference_stream`` equal JAX's ``reference_stream`` on the f32
  qwen3-moe-30b-a3b smoke config, and temperature 0.8 moves at least one
  token off greedy.
"""
import dataclasses

import jax
import jax.extend.random as jrandom_ext
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch.convert import params_from_jax
from repro_torch.launch import sampling
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

SEEDS = [0, 1, 1003, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -1]
STEPS = np.arange(301)
N_BITS = 512
GUMBEL_ULP = 2
UNIFORM_RANGES = [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                  (-3.5, 2.25), (1e-3, 7.0)]


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _fold_in_all(seed):
    """JAX's and the port's keys of every step in STEPS."""
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  s))(jnp.asarray(STEPS))
    tkeys = sampling.fold_in(sampling.prng_key(seed), torch.from_numpy(STEPS))
    return jkeys, tkeys


def test_threefry2x32_matches_jax():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2 ** 32, size=64, dtype=np.uint64).astype(
        np.uint32)
    count[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    want = _words(jrandom_ext.threefry_2x32(jnp.asarray(key),
                                            jnp.asarray(count)))
    o0, o1 = sampling.threefry2x32(torch.from_numpy(_words(key)),
                                   torch.from_numpy(_words(count[:32])),
                                   torch.from_numpy(_words(count[32:])))
    np.testing.assert_array_equal(torch.cat([o0, o1]).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    np.testing.assert_array_equal(sampling.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))
    assert sampling.prng_key(seed).tolist() == [0, seed % 2 ** 32]
    jkeys, tkeys = _fold_in_all(seed)
    np.testing.assert_array_equal(tkeys.numpy(), _words(jkeys))
    # unbatched calls agree with the batched ones
    for step in (0, 1, 300):
        assert sampling.fold_in(sampling.prng_key(seed), step).tolist() == \
            _words(jax.random.fold_in(jax.random.PRNGKey(seed),
                                      step)).tolist()
    # a batch of seeds keys each row as alone
    batch = sampling.prng_key([seed, 7])
    assert batch.tolist() == [sampling.prng_key(seed).tolist(), [0, 7]]


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_match_jax(seed):
    jkeys, tkeys = _fold_in_all(seed)
    jbits = jax.vmap(lambda k: jax.random.bits(k, (N_BITS,), jnp.uint32))(
        jkeys)
    np.testing.assert_array_equal(sampling.random_bits(tkeys, N_BITS).numpy(),
                                  _words(jbits))
    for lo, hi in UNIFORM_RANGES:
        ju = jax.vmap(lambda k: jax.random.uniform(
            k, (N_BITS,), jnp.float32, lo, hi))(jkeys)
        tu = sampling.uniform(tkeys, N_BITS, lo, hi)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))
        assert float(tu.min()) >= np.float32(lo)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(seed):
    jkeys, tkeys = _fold_in_all(seed)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (N_BITS,), jnp.float32))(jkeys))
    tg = sampling.gumbel(tkeys, N_BITS).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), np.float32(1.0)))
    assert np.all(np.isfinite(tg))
    assert float((np.abs(tg - jg) / ulp).max()) <= GUMBEL_ULP


def _pairs(n=256, seed=3):
    rng = np.random.default_rng(seed)
    return [(int(s), int(t)) for s, t in zip(
        rng.choice(SEEDS + list(range(2, 200)), size=n),
        rng.integers(0, 301, size=n))]


@pytest.mark.parametrize("vocab", [64, 151936])
@pytest.mark.parametrize("temperature", [0.8, 1.3])
def test_categorical_and_next_token_match_jax(vocab, temperature):
    """All 256 pairs through ``jax.random.categorical`` (vmapped, 4 keys a
    call) against the port's ``sample_rows``; the port's ``categorical``
    and the engines' ``next_token`` (JAX's and the port's, numpy and
    tensor rows) on the first 16."""
    rng = np.random.default_rng(vocab)
    pairs = _pairs()
    rows = (rng.normal(size=(4, vocab)) * 2).astype(np.float32)
    draw = jax.jit(jax.vmap(lambda k, r: jax.random.categorical(
        k, r / temperature)))
    for c in range(0, len(pairs), 4):
        chunk = pairs[c:c + 4]
        seeds = [s for s, _ in chunk]
        steps = [t for _, t in chunk]
        batch = rows[np.arange(c, c + len(chunk)) % len(rows)]
        jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), t)
                           for s, t in chunk])
        want = np.asarray(draw(jkeys, jnp.asarray(batch))).tolist()
        assert sampling.sample_rows(torch.from_numpy(batch), seeds, steps,
                                    [temperature] * len(chunk)).tolist() \
            == want
        if c >= 16:
            continue
        tkeys = sampling.fold_in(sampling.prng_key(seeds),
                                 torch.tensor(steps))
        scaled = torch.from_numpy(batch) / torch.tensor(
            temperature, dtype=torch.float32)
        assert sampling.categorical(tkeys, scaled).tolist() == want
        for i, (seed, step) in enumerate(chunk):
            req = dict(rid=0, prompt=np.arange(2), max_new=400,
                       out=[0] * step, temperature=temperature, seed=seed)
            assert jserve.next_token(batch[i],
                                     jserve.Request(**req)) == want[i]
            assert tserve.next_token(batch[i],
                                     tserve.Request(**req)) == want[i]
            assert tserve.next_token(torch.from_numpy(batch[i]),
                                     tserve.Request(**req)) == want[i]


def test_sample_rows_matches_next_token():
    """The batched draw of mixed greedy and sampled rows equals each row's
    ``next_token``; greedy rows keep the f32 argmax (lowest index on a
    tie)."""
    rng = np.random.default_rng(9)
    vocab = 1000
    rows = rng.normal(size=(6, vocab)).astype(np.float32)
    rows[0, 7] = rows[0, 11] = rows[0].max() + 1.0       # a greedy tie
    temps = [0.0, 0.8, 1.3, 0.8, -1.0, 2.0]
    seeds = [0, 5, 2 ** 32 + 5, -1, 3, 1003]
    steps = [0, 3, 17, 300, 2, 0]
    got = sampling.sample_rows(torch.from_numpy(rows), seeds, steps, temps)
    assert got.dtype == torch.int64 and got.shape == (6,)
    for i in range(6):
        req = tserve.Request(rid=i, prompt=np.arange(2), max_new=400,
                             out=[0] * steps[i], temperature=temps[i],
                             seed=seeds[i])
        assert int(got[i]) == tserve.next_token(rows[i], req)
        jreq = jserve.Request(rid=i, prompt=np.arange(2), max_new=400,
                              out=[0] * steps[i], temperature=temps[i],
                              seed=seeds[i])
        assert int(got[i]) == jserve.next_token(rows[i], jreq)
    assert int(got[0]) == 7
    # all-greedy batches draw no key
    assert sampling.sample_rows(torch.from_numpy(rows), seeds, steps,
                                [0.0] * 6).tolist() == \
        np.argmax(rows, axis=1).tolist()
    # bf16 rows upcast before the draw, as next_token's np.float32 row
    bf = torch.from_numpy(rows).bfloat16()
    assert sampling.sample_rows(bf, seeds, steps, temps).tolist() == \
        sampling.sample_rows(bf.float(), seeds, steps, temps).tolist()


def test_sampled_stream_parity_across_engines():
    """A sampled request's stream is a pure function of (seed, step,
    logits): the port's dense and paged servers and its batch-1 reference
    draw JAX's ``reference_stream`` tokens, and temperature 0.8 moves the
    stream off greedy."""
    arch = "qwen3-moe-30b-a3b"
    cfg_j = dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32")
    cfg_t = dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32")
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    jpcfg, tpcfg = JPC(blk=8, impl="pallas"), TPC(blk=8)
    max_seq, slots = 32, 3
    rng = np.random.default_rng(41)
    reqs = []
    for i in range(6):
        plen = int(rng.integers(2, 14))
        reqs.append(dict(rid=i, prompt=rng.integers(
            0, cfg_t.vocab_size, size=plen).astype(np.int32),
            max_new=int(rng.integers(2, 7)), temperature=0.8,
            seed=1000 + i))
    jstep = jax.jit(jsteps.make_serve_step(cfg_j, jpcfg, None,
                                           (1, 1, cfg_j.d_model)))
    tstep = tsteps.make_serve_step(cfg_t, tpcfg)
    want = {r["rid"]: jserve.reference_stream(
        cfg_j, jpcfg, None, pj, jserve.Request(**r), max_seq=max_seq,
        step=jstep) for r in reqs}
    ref = {r["rid"]: tserve.reference_stream(
        cfg_t, tpcfg, pt, tserve.Request(**r), max_seq=max_seq, step=tstep)
        for r in reqs}
    greedy = {r["rid"]: tserve.greedy_reference(
        cfg_t, tpcfg, pt, r["prompt"], r["max_new"], max_seq=max_seq,
        step=tstep) for r in reqs}
    assert ref == want
    assert any(ref[k] != greedy[k] for k in ref), \
        "temperature 0.8 never moved a token off argmax"

    def serve(server):
        for r in reqs:
            server.submit(tserve.Request(**r))
        return {r.rid: r.out for r in server.run()}

    dense = serve(tserve.BatchedServer(cfg_t, tpcfg, num_slots=slots,
                                       max_seq=max_seq, params=pt,
                                       device="cpu"))
    maxp = max_seq // 4
    paged = serve(tserve.PagedServer(
        cfg_t, tpcfg, num_slots=slots, page_size=4,
        num_pages=1 + slots * maxp, max_pages_per_slot=maxp, params=pt,
        prefill_chunk=5, device="cpu"))
    assert dense == want, "dense sampled stream diverged"
    assert paged == want, "paged sampled stream diverged"
