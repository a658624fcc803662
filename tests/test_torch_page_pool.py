"""PyTorch port vs the JAX package: the copy-on-write page pool, the radix
prefix index and the page-pool shares (``parallel/cache.py``).

Every operation runs on a JAX ``PagePool``/``PrefixIndex`` and on the
port's in lockstep (``_Twin``): the same return values (page ids,
matches, counts), the same exception types on the same calls, and after
every call the same refcounts, owners, free lists and ``stats()``.

* ``tests/test_page_refcount.py``'s op interpreter (admit with match + fork +
  reserve-evicting, alloc, CoW write, insert, finish, evict, abort and
  retry, rollback) over its pinned op sequences, a seeded fuzz, and a
  hypothesis run with a fixed seed, on one budget and on shares
  ``[10, 6]``; the structural oracle (refcount == slot holders + trie
  nodes) after every op and a drained pool at the end;
* the explicit cases: double release, fork of a free page, CoW, release
  only at refcount 0, owner-credited budgets, the trie's match, insert,
  evict and clear, partial pages never indexed;
* ``page_shares`` over a grid of weights (numpy's argsort ties), and
  ``reshare`` on a drained and on a live pool.
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, seed, settings, strategies as st

from repro.parallel.cache import PagePool as JPool, PrefixIndex as JIndex
from repro.parallel.cache import page_shares as jshares
from repro_torch.parallel.cache import PagePool as TPool, PrefixIndex as TIndex
from repro_torch.parallel.cache import page_shares as tshares

PAGE = 2          # tokens per page (tiny: collisions are the point)
NUM_PAGES = 17    # 16 allocatable + sink
N_FAMILIES = 3


def _state(pool):
    return (dict(pool._ref), dict(pool._owner), list(pool._free_list),
            list(pool._free), list(pool._reserved), list(pool._in_use),
            list(pool.shares), pool.stats())


def _trie(index):
    out, stack = [], [(index.root, ())]
    while stack:
        node, path = stack.pop()
        for key, child in sorted(node.children.items()):
            out.append((path + (key,), child.page, child.last_used))
            stack.append((child, path + (key,)))
    return sorted(out), index.stats()


def _call(obj, name, args, kw):
    try:
        return ("ok", getattr(obj, name)(*args, **kw))
    except Exception as e:                       # noqa: BLE001
        return ("raise", type(e))


class _Twin:
    """A JAX object and its port driven in lockstep; any divergence in a
    result, a raise or the resulting state fails the test."""

    def __init__(self, j, t, state):
        self.j, self.t, self._state = j, t, state

    def __getattr__(self, name):
        def call(*args, **kw):
            jargs = [a.j if isinstance(a, _Twin) else a for a in args]
            targs = [a.t if isinstance(a, _Twin) else a for a in args]
            got = _call(self.t, name, targs, kw)
            want = _call(self.j, name, jargs, kw)
            assert got == want, (name, args, kw, got, want)
            self.check()
            if got[0] == "raise":
                raise got[1]("raised by both packages")
            return got[1]
        return call

    def check(self):
        assert self._state(self.t) == self._state(self.j)


def _twin_pool(num_pages=NUM_PAGES, **kw):
    return _Twin(JPool(num_pages, **kw), TPool(num_pages, **kw), _state)


def _twin_index(page=PAGE):
    return _Twin(JIndex(page), TIndex(page), _trie)


def _prompt(family: int, n_pages: int) -> list:
    return [family * 100 + j for j in range(n_pages * PAGE)]


class _Ops:
    """``tests/test_page_refcount.py``'s op interpreter over twin pools,
    with its shadow model of every reference holder."""

    def __init__(self, shares=None):
        self.pool = _twin_pool(shares=shares)
        self.index = _twin_index()
        self.n_groups = len(self.pool.j.shares)
        self.slots = {}
        self._sid = 0

    def admit(self, seed_: int):
        family = seed_ % N_FAMILIES
        need = 1 + (seed_ // N_FAMILIES) % 4
        group = (seed_ // 16) % self.n_groups
        prompt = _prompt(family, need)
        matched = self.index.match(prompt, (len(prompt) - 1) // PAGE)
        if matched:
            self.pool.fork(matched)
        reserve_n = need - len(matched)
        while not self.pool.try_reserve(reserve_n, group):
            if not self.index.evict_lru(self.pool):
                if matched:
                    self.pool.release(matched)
                return
        self.slots[self._sid] = {
            "group": group, "prompt": prompt, "pages": list(matched),
            "need": need, "reserved": reserve_n, "allocated": 0,
            "matched_n": len(matched)}
        self._sid += 1

    def alloc(self, seed_: int):
        s = self._pick(seed_)
        if s is None or s["allocated"] >= s["reserved"]:
            return
        s["pages"].append(self.pool.alloc(s["group"]))
        s["allocated"] += 1

    def write(self, seed_: int):
        s = self._pick(seed_)
        if s is None or not s["pages"]:
            return
        j = seed_ % len(s["pages"])
        page = s["pages"][j]
        if self.pool.refcount(page) <= 1:
            assert self.pool.cow(page, s["group"]) == page
            return
        while not self.pool.try_reserve(1, s["group"]):
            if not self.index.evict_lru(self.pool):
                return
        s["reserved"] += 1
        s["pages"][j] = self.pool.cow(page, s["group"])
        s["allocated"] += 1

    def insert(self, seed_: int):
        s = self._pick(seed_)
        if s is None or len(s["pages"]) < s["need"]:
            return
        self.index.insert(s["prompt"], s["pages"][:s["need"]], self.pool)

    def finish(self, seed_: int):
        s = self._pick(seed_)
        if s is None:
            return
        self.pool.release(s["pages"], s["group"],
                          unused_reserved=s["reserved"] - s["allocated"])
        del self.slots[[k for k, v in self.slots.items() if v is s][0]]

    def abort(self, seed_: int):
        s = self._pick(seed_)
        if s is None:
            return
        self.finish(seed_)
        self.check()
        self.admit(seed_)

    def rollback(self, seed_: int):
        s = self._pick(seed_)
        if s is None or len(s["pages"]) <= s["matched_n"]:
            return
        page = s["pages"][-1]
        if self.pool.refcount(page) != 1:
            return
        self.pool.rollback([page], s["group"])
        s["pages"].pop()
        s["allocated"] -= 1

    def evict(self, seed_: int):
        self.index.evict_lru(self.pool)

    def _pick(self, seed_: int):
        if not self.slots:
            return None
        return self.slots[sorted(self.slots)[seed_ % len(self.slots)]]

    def check(self):
        self.pool.assert_consistent()
        held = {}
        for s in self.slots.values():
            for p in s["pages"]:
                held[p] = held.get(p, 0) + 1
        for p in self.index.t.pages():
            held[p] = held.get(p, 0) + 1
        for p in range(1, NUM_PAGES):
            assert self.pool.refcount(p) == held.get(p, 0), p

    def drain(self):
        for _ in range(len(self.slots)):
            self.finish(0)
        self.index.clear(self.pool)
        self.check()
        assert len(self.index.t) == len(self.index.j) == 0
        assert self.pool.t.in_use_pages == self.pool.t.reserved_pages == 0
        assert self.pool.t.free_pages == sum(self.pool.t.shares)
        assert self.pool.t.total_allocs == self.pool.t.total_frees


OPS = ("admit", "alloc", "write", "insert", "finish", "evict", "abort",
       "rollback")
SHARES_SAMPLES = [None, [10, 6]]


def _check_ops(ops, shares=None):
    d = _Ops(shares)
    for name, s in ops:
        getattr(d, name)(s)
        d.check()
    d.drain()


OPS_SAMPLES = [      # tests/test_page_refcount.py's pinned sequences
    [("admit", 0), ("alloc", 0), ("alloc", 0), ("insert", 0),
     ("admit", 0), ("write", 0), ("write", 1), ("finish", 0),
     ("finish", 0), ("evict", 0)],
    [("admit", 9), ("alloc", 0), ("alloc", 0), ("insert", 0), ("finish", 0),
     ("admit", 10), ("alloc", 0), ("alloc", 0), ("insert", 0), ("finish", 0),
     ("admit", 11), ("alloc", 0), ("alloc", 0), ("insert", 0), ("finish", 0),
     ("admit", 9), ("admit", 10), ("admit", 11), ("finish", 0),
     ("finish", 0), ("finish", 0)],
    [("admit", 3), ("alloc", 0), ("insert", 0), ("admit", 3),
     ("finish", 0), ("write", 0), ("alloc", 0), ("evict", 0),
     ("insert", 0), ("finish", 0)],
    [("admit", 0), ("alloc", 0), ("abort", 0), ("alloc", 0),
     ("insert", 0), ("admit", 0), ("abort", 1), ("abort", 0),
     ("finish", 0), ("evict", 0)],
    [("admit", 9), ("alloc", 0), ("alloc", 0), ("insert", 0),
     ("admit", 9), ("write", 0), ("abort", 1), ("abort", 0),
     ("admit", 10), ("abort", 0), ("evict", 0), ("finish", 0)],
    [("admit", 0), ("alloc", 0), ("alloc", 0), ("rollback", 0),
     ("alloc", 0), ("insert", 0), ("rollback", 0), ("admit", 0),
     ("rollback", 1), ("evict", 0), ("rollback", 0), ("finish", 0),
     ("finish", 0)],
    [("admit", 19), ("alloc", 0), ("rollback", 0), ("rollback", 0),
     ("alloc", 0), ("abort", 0), ("alloc", 0), ("rollback", 0),
     ("finish", 0)],
]


@pytest.mark.parametrize("shares", SHARES_SAMPLES)
@pytest.mark.parametrize("ops_i", range(len(OPS_SAMPLES)))
def test_ops_pinned_in_lockstep(ops_i, shares):
    _check_ops(OPS_SAMPLES[ops_i], shares)


def test_ops_fuzz_in_lockstep():
    rng = np.random.default_rng(0)
    for case in range(60):
        n = int(rng.integers(1, 40))
        ops = [(OPS[int(rng.integers(len(OPS)))], int(rng.integers(128)))
               for _ in range(n)]
        _check_ops(ops, SHARES_SAMPLES[case % len(SHARES_SAMPLES)])


@seed(20261017)
@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, 127)),
                    min_size=1, max_size=40),
       shares=st.sampled_from(SHARES_SAMPLES))
def test_ops_property_in_lockstep(ops, shares):
    _check_ops(ops, shares)


# ---------------------------------------------------------------------------
# explicit cases
# ---------------------------------------------------------------------------

def _pool_with_page():
    pool = _twin_pool()
    assert pool.try_reserve(2)
    return pool, pool.alloc()


def test_double_release_raises_and_changes_nothing():
    pool, page = _pool_with_page()
    pool.release([page])
    with pytest.raises(RuntimeError):
        pool.release([page])
    with pytest.raises(RuntimeError, match="double release"):
        pool.t.release([page])
    pool.release([], unused_reserved=1)
    pool.assert_consistent()


def test_fork_of_a_free_page_or_the_sink_raises():
    pool, page = _pool_with_page()
    pool.release([page])
    with pytest.raises(RuntimeError):
        pool.fork([page])
    with pytest.raises(ValueError):
        pool.fork([0])
    with pytest.raises(RuntimeError, match="fork of free page"):
        pool.t.fork([page])


def test_cow_semantics():
    pool, page = _pool_with_page()
    assert pool.cow(page) == page
    pool.fork([page])
    new = pool.cow(page)
    assert new != page
    assert pool.refcount(page) == 1 and pool.refcount(new) == 1
    assert pool.t.stats()["total_cow_copies"] == 1
    pool.release([page, new])
    with pytest.raises(RuntimeError):
        pool.cow(page)


def test_release_frees_only_at_refcount_zero():
    pool, page = _pool_with_page()
    pool.fork([page])
    pool.release([page])
    assert pool.refcount(page) == 1 and pool.t.in_use_pages == 1
    pool.release([page], unused_reserved=1)
    assert pool.refcount(page) == 0 and pool.t.free_pages == NUM_PAGES - 1


def test_owner_group_credited_across_groups():
    pool = _twin_pool(shares=[10, 6])
    assert pool.try_reserve(1, 0)
    page = pool.alloc(0)
    pool.fork([page])
    pool.release([page], group=0)
    assert pool.group_free(0) == 9
    pool.release([page], group=1)
    assert pool.group_free(0) == 10 and pool.group_free(1) == 6
    with pytest.raises(RuntimeError):           # over-released
        pool.release([], group=1, unused_reserved=1)


def test_rollback_refuses_shared_and_foreign_pages():
    pool = _twin_pool(shares=[10, 6])
    assert pool.try_reserve(2, 0)
    a, b = pool.alloc(0), pool.alloc(0)
    pool.fork([a])
    with pytest.raises(RuntimeError):           # refcount 2
        pool.rollback([a], 0)
    with pytest.raises(RuntimeError):           # owned by group 0
        pool.rollback([b], 1)
    pool.rollback([b], 0)
    assert pool.t.reserved_pages == 1


def test_trie_match_fork_evict():
    pool = _twin_pool()
    idx = _twin_index()
    prompt = _prompt(0, 3)
    assert pool.try_reserve(3)
    pages = [pool.alloc() for _ in range(3)]
    assert idx.insert(prompt, pages, pool) == 3
    assert idx.insert(prompt, pages, pool) == 0
    assert idx.match(prompt, 2) == pages[:2]
    pool.release(pages)
    assert pool.t.in_use_pages == 3
    assert idx.evict_lru(pool)
    assert len(idx.t) == 2 and pool.refcount(pages[2]) == 0
    pool.fork([pages[0]])
    pool.fork([pages[1]])
    assert idx.evict_lru(pool) is False
    pool.release([pages[0]])
    pool.release([pages[1]])
    assert idx.clear(pool) == 2
    assert pool.t.free_pages == NUM_PAGES - 1
    assert sorted(idx.t.pages()) == []


def test_partial_page_never_indexed():
    pool = _twin_pool()
    idx = _twin_index()
    assert pool.try_reserve(1)
    page = pool.alloc()
    assert idx.insert([7], [page][: 1 // PAGE], pool) == 0
    assert idx.match([7, 8], (2 - 1) // PAGE) == []
    assert len(idx.t) == 0
    pool.release([page])


def test_lru_evicts_the_least_recently_matched_leaf():
    pool = _twin_pool()
    idx = _twin_index()
    for fam in range(3):
        prompt = _prompt(fam, 2)
        assert pool.try_reserve(2)
        pages = [pool.alloc() for _ in range(2)]
        idx.insert(prompt, pages, pool)
        pool.release(pages)
    idx.match(_prompt(0, 2), 2)                 # family 0 is fresh again
    assert idx.evict_lru(pool)                  # family 1's leaf goes
    assert len(idx.match(_prompt(1, 2), 2)) == 1
    assert idx.t.stats()["evictions"] == 1
    assert idx.clear(pool) == 5


# ---------------------------------------------------------------------------
# shares
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("usable", [1, 7, 16, 100, 1023])
def test_page_shares_match_jax(usable):
    grid = [(1,), (1, 1), (2, 1), (1, 2), (3, 3, 3), (3, 2, 2, 1),
            (1.0, 1.5, 2.5), (5, 0, 5), (0.1, 0.7, 0.2), (4, 4, 2, 2, 1, 1)]
    for w in grid:
        assert tshares(w, usable) == jshares(w, usable), w
    for bad in ((0, 0), (-1, 2)):
        with pytest.raises(ValueError):
            tshares(bad, usable)


def test_reshare_on_a_drained_pool_only():
    pool = _twin_pool(shares=[10, 6])
    assert pool.try_reserve(2, 1)
    page = pool.alloc(1)
    with pytest.raises(RuntimeError):
        pool.reshare([16])
    pool.release([page], 1, unused_reserved=1)
    pool.reshare([16])
    assert pool.t.shares == [16]
    with pytest.raises(ValueError):
        pool.reshare([10, 7])
    with pytest.raises(ValueError):
        pool.reshare([-1, 3])
    pool.reshare(jshares((2, 1), NUM_PAGES - 1))
    assert pool.t.shares == [11, 5]
    assert pool.try_reserve(5, 1) and not pool.try_reserve(1, 1)
