"""Seeded categorical sampling, bit for bit as ``jax.random`` draws it.

The JAX engines sample a row at ``temperature > 0`` with
``jax.random.categorical(fold_in(PRNGKey(seed), step), row / temperature)``
under the default PRNG (``threefry2x32``, partitionable counters, 32-bit
mode). This module is the port's own copy of exactly that path, in torch
integer ops on whatever device the logits lie on: every 32-bit word is
held in an int64 lane and masked to 32 bits after each add and rotate
(no op here relies on unsigned 32-bit shifts).

- ``threefry2x32``: the 20-round Threefry-2x32 hash.
- ``prng_key(seed)``: ``PRNGKey`` with 64-bit ints off, ``(0, seed mod
  2**32)``.
- ``fold_in(key, n)``: ``threefry2x32(key, (0, n))``.
- ``random_bits(key, n)``: ``o1 ^ o2`` of ``threefry2x32(key, (i >> 32,
  i mod 2**32))`` over the counters ``i = 0..n-1``.
- ``uniform``: the mantissa ``bits >> 9 | 0x3F800000`` as f32, minus 1,
  scaled, then ``max(minval, .)``.
- ``gumbel``: mode "low", ``-log(-log(uniform(tiny, 1)))``.
- ``categorical``: ``argmax(logits + gumbel)``, lowest index on ties.

``sample_rows`` is the batched form the engines call: one row a request,
keys from ``(seed, step)``, greedy rows (temperature <= 0) by the f32
argmax.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key`` (..., 2). Every operand is int64 holding a 32-bit word; the
    leading dims broadcast. Returns the two output words."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit ints off: ``(0, seed mod
    2**32)`` as int64 (2,); a sequence of seeds gives (B, 2)."""
    seeds = [int(s) & MASK32 for s in np.atleast_1d(np.asarray(seed, object))]
    key = torch.tensor([[0, s] for s in seeds], dtype=torch.int64,
                       device=device)
    return key if np.ndim(seed) else key[0]


def fold_in(key: torch.Tensor, n) -> torch.Tensor:
    """``jax.random.fold_in(key, n)``: the hash of the counter ``(0, n)``.
    ``key`` (..., 2); ``n`` an int or an int tensor of the leading shape."""
    n = torch.as_tensor(n, dtype=torch.int64, device=key.device)
    data = (n & MASK32)[..., None]
    o0, o1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.cat([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words (as int64) over ``n`` counters: ``(..., n)``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key, i >> 32, i & MASK32)
    return o0 ^ o1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in ``[minval, maxval)``, ``(..., n)``, as
    ``jax.random.uniform`` computes them. XLA fuses ``floats * (maxval -
    minval) + minval`` into one multiply-add, rounded once: here the
    product and sum are exact in f64 (a 23-bit fraction times a 24-bit
    scale) and round once to f32."""
    bits = (random_bits(key, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 standard Gumbel draws (``jax.random.gumbel``'s "low" mode)."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of f32
    ``logits`` (..., V), ``key`` (..., 2): the Gumbel-max index."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                steps: Sequence[int],
                temperatures: Sequence[float]) -> torch.Tensor:
    """One token a row of ``logits`` (B, V), on the logits' device: row
    ``i`` at ``temperatures[i] <= 0`` by the f32 argmax, else drawn by
    ``categorical(fold_in(prng_key(seeds[i]), steps[i]), row /
    temperatures[i])`` with the division in f32. Returns int64 (B,)."""
    rows = logits.float()
    tokens = torch.argmax(rows, dim=-1)
    hot = [i for i, t in enumerate(temperatures) if t > 0.0]
    if not hot:
        return tokens
    dev = rows.device
    keys = fold_in(prng_key([seeds[i] for i in hot], dev),
                   torch.tensor([steps[i] for i in hot], device=dev))
    temps = torch.tensor([temperatures[i] for i in hot],
                         dtype=torch.float32, device=dev)
    idx = torch.tensor(hot, device=dev)
    tokens[idx] = categorical(keys, rows[idx] / temps[:, None])
    return tokens
