"""Deterministic, resumable, host-sharded token data (counterpart of
``repro.data.pipeline``; numpy only, copied so that the batches are
bit-identical to the JAX package's).

Every batch is a pure function of (seed, step, host shard): a restart at
step N sees exactly the stream a continuous run would have seen, the
property checkpoint-restart fault tolerance depends on. Sources:

  * synthetic: an order-1 Markov token stream over token classes
    (token % K), drawn from a counter-based generator (Philox), so there
    is no state. Its distribution is learnable: the convergence examples
    show the loss dropping below the unigram entropy floor.
  * memmap: an int32 token file cut into strided windows, the window
    order shuffled by a generator keyed by the step.

``TokenSource(cfg, num_shards, shard, shares)`` gives host ``shard`` its
rows of the global batch; ``shares`` (default: even) are uneven per-host
batch shares, so the heterogeneous planner (``core.hetero``, paper Eq. 1)
can re-split the load between steps (``set_shares``). ``Prefetcher``
assembles the next batches on a background thread while the device
computes.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    kind: str = "synthetic"       # synthetic | memmap
    seed: int = 0
    path: Optional[str] = None    # memmap token file
    markov_order: int = 1


def _philox(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[step, shard, 0, 0])
    )


class TokenSource:
    """Deterministic batch source; indexable by (step, shard)."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1, shard: int = 0,
                 shares: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard = shard
        self.set_shares(shares)
        if cfg.kind == "memmap":
            if not cfg.path:
                raise ValueError("memmap source needs a path")
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        elif cfg.kind == "synthetic":
            rng = _philox(cfg.seed, 0, 2**31 - 1)
            v = cfg.vocab_size
            # Markov chain over K token *classes* (token % K) so the table
            # stays small for large vocabs; within-class choice is uniform.
            self._k = min(v, 512)
            logits = rng.normal(size=(self._k, self._k)).astype(np.float32) * 2.0
            trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            self._cum = np.cumsum(trans, axis=1)
        else:
            raise ValueError(cfg.kind)

    def set_shares(self, shares: Optional[Sequence[int]]) -> None:
        """Per-shard batch shares (heterogeneous splits). None = uniform."""
        if shares is None:
            if self.cfg.global_batch % self.num_shards:
                raise ValueError(
                    f"global batch {self.cfg.global_batch} does not split "
                    f"evenly over {self.num_shards} shards")
            shares = [self.cfg.global_batch // self.num_shards] * self.num_shards
        if sum(shares) != self.cfg.global_batch:
            raise ValueError(f"shares {list(shares)} do not sum to the "
                             f"global batch {self.cfg.global_batch}")
        self._shares = list(shares)
        self._offsets = np.concatenate([[0], np.cumsum(shares)])

    @property
    def local_batch(self) -> int:
        return self._shares[self.shard]

    def batch(self, step: int) -> dict:
        """Host-local {tokens, labels, loss_mask} for this shard at step."""
        n = self._shares[self.shard]
        s = self.cfg.seq_len
        if self.cfg.kind == "synthetic":
            rng = _philox(self.cfg.seed, step, self.shard)
            v, k = self.cfg.vocab_size, self._k
            toks = np.empty((n, s + 1), np.int32)
            toks[:, 0] = rng.integers(0, v, size=n)
            u = rng.random(size=(n, s)).astype(np.float32)
            blocks = rng.integers(0, max(v // k, 1), size=(n, s)).astype(np.int32)
            for t in range(s):
                cls = (self._cum[toks[:, t] % k] < u[:, t:t + 1]).sum(axis=1)
                toks[:, t + 1] = np.minimum(cls + blocks[:, t] * k, v - 1)
        else:
            total_windows = (len(self._tokens) - 1) // s
            rng = _philox(self.cfg.seed, step, 0)
            order = rng.permutation(total_windows)
            base = (step * self.cfg.global_batch) % total_windows
            idx = order[(base + self._offsets[self.shard]
                         + np.arange(n)) % total_windows]
            toks = np.stack(
                [self._tokens[i * s:i * s + s + 1] for i in idx]
            ).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((n, s), np.float32),
        }


class Prefetcher:
    """Background-thread prefetch queue over a TokenSource."""

    def __init__(self, source: TokenSource, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
