"""PyTorch port vs the JAX package: the token data pipeline.

The module is numpy in both packages, copied into the port, so every batch
must be bit-identical: the synthetic Markov source (the batches the port
has always given, one host), the memmap source over an int32 token file
each test writes under ``tmp_path``, host shards with even and uneven
``shares`` (``local_batch``, ``set_shares`` between steps), and the
``Prefetcher`` thread's (step, batch) stream from a start step. Bad shares
and a memmap source without a path raise.
"""
import numpy as np
import pytest

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp

VOCAB = 300


def _equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _token_file(tmp_path, n=4001, seed=2):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(seed).integers(0, VOCAB, size=n).astype(
        np.int32).tofile(path)
    return str(path)


def _sources(**kw):
    shard_kw = {k: kw.pop(k) for k in ("num_shards", "shard", "shares")
                if k in kw}
    return (jp.TokenSource(jp.DataConfig(**kw), **shard_kw),
            tp.TokenSource(tp.DataConfig(**kw), **shard_kw))


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_one_host_batches_equal_jax(tmp_path, kind):
    path = _token_file(tmp_path) if kind == "memmap" else None
    js, ts = _sources(seq_len=24, global_batch=5, vocab_size=VOCAB,
                      kind=kind, seed=4, path=path)
    for step in (0, 1, 7, 123):
        _equal(ts.batch(step), js.batch(step))
    assert ts.local_batch == 5


def test_synthetic_batches_unchanged_by_keywords():
    """The keyword-built config of the port's earlier, one-host source
    (seq_len, global_batch, vocab_size, seed) gives the same batches."""
    cfg = tp.DataConfig(seq_len=16, global_batch=3, vocab_size=VOCAB, seed=9)
    assert cfg.kind == "synthetic" and cfg.path is None \
        and cfg.markov_order == 1
    a = tp.TokenSource(cfg).batch(5)
    b = jp.TokenSource(jp.DataConfig(seq_len=16, global_batch=3,
                                     vocab_size=VOCAB, seed=9)).batch(5)
    _equal(a, b)


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
@pytest.mark.parametrize("shares", [None, (1, 4, 3)])
def test_host_shards_equal_jax(tmp_path, kind, shares):
    path = _token_file(tmp_path) if kind == "memmap" else None
    for shard in range(3):
        js, ts = _sources(seq_len=12, global_batch=8 if shares else 9,
                          vocab_size=VOCAB, kind=kind, seed=1, path=path,
                          num_shards=3, shard=shard, shares=shares)
        assert ts.local_batch == js.local_batch
        for step in (0, 3):
            _equal(ts.batch(step), js.batch(step))
        # a replan re-splits the same global batch between steps
        new = (3, 3, 2) if shares else (2, 3, 4)
        js.set_shares(new)
        ts.set_shares(new)
        assert ts.local_batch == new[shard]
        _equal(ts.batch(4), js.batch(4))


def test_bad_shares_and_missing_path_raise():
    cfg = tp.DataConfig(seq_len=8, global_batch=5, vocab_size=VOCAB)
    with pytest.raises(ValueError, match="split evenly"):
        tp.TokenSource(cfg, num_shards=2)
    with pytest.raises(ValueError, match="do not sum"):
        tp.TokenSource(cfg, num_shards=2, shares=(1, 3))
    with pytest.raises(ValueError, match="needs a path"):
        tp.TokenSource(tp.DataConfig(seq_len=8, global_batch=2,
                                     vocab_size=VOCAB, kind="memmap"))
    with pytest.raises(ValueError):
        tp.TokenSource(tp.DataConfig(seq_len=8, global_batch=2,
                                     vocab_size=VOCAB, kind="parquet"))


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_prefetcher_stream_equals_jax(tmp_path, kind):
    path = _token_file(tmp_path) if kind == "memmap" else None
    js, ts = _sources(seq_len=10, global_batch=4, vocab_size=VOCAB,
                      kind=kind, seed=3, path=path, num_shards=2, shard=1,
                      shares=(1, 3))
    jf = jp.Prefetcher(js, start_step=5, depth=2)
    tf = tp.Prefetcher(ts, start_step=5, depth=2)
    try:
        for want_step in range(5, 10):
            (s1, b1), (s2, b2) = next(tf), next(jf)
            assert s1 == s2 == want_step
            _equal(b1, b2)
            _equal(b1, ts.batch(want_step))
    finally:
        tf.close()
        jf.close()
    assert not tf._thread.is_alive()
