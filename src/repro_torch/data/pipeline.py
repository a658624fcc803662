"""Deterministic synthetic token data (counterpart of
``repro.data.pipeline``; numpy only, copied so that the batches are
bit-identical to the JAX package's).

Every batch is a pure function of (seed, step): an order-1 Markov token
stream over token classes (token % K), drawn from a counter-based
generator (Philox), so a restart at step N sees what a continuous run
would have seen. Only the synthetic source of one host is ported; the
memmap source, host shards with uneven shares and the prefetch thread
belong to later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0


def _philox(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[step, shard, 0, 0])
    )


class TokenSource:
    """Deterministic batch source of one host (shard 0), indexable by
    step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.shard = 0
        rng = _philox(cfg.seed, 0, 2**31 - 1)
        v = cfg.vocab_size
        # Markov chain over K token *classes* (token % K) so the table
        # stays small for large vocabs; within-class choice is uniform.
        self._k = min(v, 512)
        logits = rng.normal(size=(self._k, self._k)).astype(np.float32) * 2.0
        trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self._cum = np.cumsum(trans, axis=1)

    def batch(self, step: int) -> dict:
        """{tokens, labels, loss_mask} numpy arrays of the batch at step."""
        n = self.cfg.global_batch
        s = self.cfg.seq_len
        rng = _philox(self.cfg.seed, step, self.shard)
        v, k = self.cfg.vocab_size, self._k
        toks = np.empty((n, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=n)
        u = rng.random(size=(n, s)).astype(np.float32)
        blocks = rng.integers(0, max(v // k, 1), size=(n, s)).astype(np.int32)
        for t in range(s):
            cls = (self._cum[toks[:, t] % k] < u[:, t:t + 1]).sum(axis=1)
            toks[:, t + 1] = np.minimum(cls + blocks[:, t] * k, v - 1)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((n, s), np.float32),
        }
