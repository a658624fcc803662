"""The one traffic generator repeats exactly from a seed, and gives every
seed the same sizes in another order."""
import itertools

import numpy as np

from hexabench import traffic


def _take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, seed, 32000), n))


def test_requests_repeat_from_a_seed():
    mix = traffic.load("serve.chat.c32")
    a, b = _take(mix, 2 ** 31 + 5, 40), _take(mix, 2 ** 31 + 5, 40)
    assert [r.max_new for r in a] == [r.max_new for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = _take(mix, 2 ** 31 + 6, 40)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_the_same_order():
    mix = traffic.load("serve.chat.c32")
    k = mix["strata"]
    sizes = [(len(r.prompt), r.max_new) for r in _take(mix, 1, 3 * k)]
    for seed in (2 ** 31 + 99, 7):
        assert [(len(r.prompt), r.max_new)
                for r in _take(mix, seed, 3 * k)] == sizes
    for blk in range(3):
        part = sizes[blk * k:(blk + 1) * k]
        assert sorted(p for p, _ in part) == \
            traffic.strata(mix["prompt_len"], k)
        assert sorted(o for _, o in part) == \
            traffic.strata(mix["output_len"], k)
    other = dict(mix, order_seed=mix["order_seed"] + 1)
    assert [len(r.prompt) for r in _take(other, 1, k)] != \
        [p for p, _ in sizes[:k]]


def test_strata_cover_the_range():
    spec = {"dist": "loguniform", "min": 32, "max": 512}
    s = traffic.strata(spec, 16)
    assert s == sorted(s) and 32 <= s[0] and s[-1] <= 512
    # the geometric midpoints of 16 equal log-slices of [32, 512]
    assert s[0] == round(32 * 16 ** (0.5 / 16))
    assert traffic.strata({"dist": "fixed", "min": 7, "max": 7}, 3) == [7] * 3
