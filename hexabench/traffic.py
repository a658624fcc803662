"""The one generator of traffic: it reads a mix's parameters
(``traffic/<mix>.json``) and a seed, and yields the work.

Every seed gets the same sizes in the same order, so runs with different
seeds do the same work: a length range is cut into ``strata``
equal-probability strata of its distribution, and each block of
``strata`` consecutive requests holds every stratum's midpoint once, in
an order drawn from the mix's ``order_seed`` (prompt and output lengths
each in their own order). The order sets how prompts queue for prefill,
and with it the time to first token, so it is the mix's and not the
run's. Token ids are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

from hexabench.inputs import derive_seed

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``name`` (``traffic/<name>.json``)."""
    with open(HERE / "traffic" / f"{name}.json") as fh:
        mix = json.load(fh)
    mix["name"] = name
    return mix


def strata(spec: dict, n: int) -> list:
    """The midpoints of ``n`` equal-probability strata of a length
    distribution, rounded to whole tokens."""
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "loguniform":
        span = math.log(hi) - math.log(lo)
        at = lambda u: math.exp(math.log(lo) + u * span)  # noqa: E731
    elif spec["dist"] == "uniform":
        at = lambda u: lo + u * (hi - lo)  # noqa: E731
    elif spec["dist"] == "fixed":
        return [int(lo)] * n
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(at((i + 0.5) / n))) for i in range(n)]


class Request(NamedTuple):
    index: int
    prompt: np.ndarray        # int32 token ids
    max_new: int


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's request stream for ``seed``, without end."""
    k = mix["strata"]
    prompt_lens = strata(mix["prompt_len"], k)
    output_lens = strata(mix["output_len"], k)
    order = np.random.default_rng(
        derive_seed(mix["order_seed"], "order", mix["name"]))
    rng = np.random.default_rng(derive_seed(seed, "traffic", mix["name"]))
    i = 0
    while True:
        for p, o in zip(order.permutation(k), order.permutation(k)):
            prompt = rng.integers(0, vocab, size=prompt_lens[p],
                                  dtype=np.int64).astype(np.int32)
            yield Request(i, prompt, output_lens[o])
            i += 1
