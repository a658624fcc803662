"""The pipeline-shared cache, the serving page pool and the radix prefix
index (counterpart of ``repro.parallel.cache``).

* ``PipelineSharedCache`` — bounded residency of gathered expert weights
  (paper §4.5): at most C layers' gathered weights are resident, and the
  next layer's gather is issued while the current one computes. Here it is
  a host-side structure: a layer loop fetches layer l's gathered tree (a
  hit, it was prefetched) and prefetches layer l+1 before layer l's
  compute, and eviction drops the last reference to the oldest layer's
  buffers. ``PlanCache`` reuses it to bound the per-plan programs of the
  straggler -> replan loop. ``gather_ffn_params`` is the gather it holds
  (the fsdp factor of each expert weight, over the mesh), and
  ``gathered_layer_bytes`` the bytes of one entry.
* ``PagePool``, ``page_shares``, ``PrefixIndex`` — host-side free list,
  copy-on-write refcounts and per-group residency accounting over the
  shared KV page pool of ``models.lm.init_paged_cache``, and the
  page-granular trie the paged engine's prefix cache matches prompts
  against.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import numpy as np

from repro_torch import obs


class _Snapshot:
    """``obs_metrics()`` from ``stats()``: one ``repro_cache_<stat>`` gauge
    per entry for the observability registry (DESIGN.md §12), told apart
    across cache kinds by the registry's ``kind`` label."""

    def obs_metrics(self) -> Dict[str, float]:
        return {f"repro_cache_{k}": float(v) for k, v in self.stats().items()}


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel()) * int(tree.element_size())
    return 0


class PipelineSharedCache(_Snapshot):
    """Bounded FIFO cache of gathered parameter trees.

    capacity_layers: maximum simultaneously-resident gathered layers. 2 is
    the double-buffer (current + prefetched next); the Janus baseline is
    effectively capacity = num_layers.
    """

    def __init__(self, capacity_layers: int = 2):
        if capacity_layers < 1:
            raise ValueError("capacity_layers must be >= 1")
        self.capacity_layers = capacity_layers
        self._resident: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0      # fetch-path gathers (critical-path stalls)
        self.prefetches = 0  # gathers issued ahead of use (overlapped)
        self.evictions = 0
        self.peak_resident_layers = 0
        self.peak_resident_bytes = 0
        obs.maybe_register(self)

    def fetch(self, key: Hashable, gather_fn: Callable[[], Any]) -> Any:
        """Return the gathered tree for ``key``, gathering on a miss."""
        if key in self._resident:
            self.hits += 1
            return self._resident[key]
        self.misses += 1
        value = gather_fn()
        self._insert(key, value)
        return value

    def prefetch(self, key: Hashable, gather_fn: Callable[[], Any]) -> None:
        """Issue the gather for ``key`` now (no-op if already resident).
        Call after fetching the current layer and before issuing its
        compute, so that the gather does not wait on it. Counted apart from
        misses: a prefetched gather is off the critical path."""
        if key not in self._resident:
            self.prefetches += 1
            self._insert(key, gather_fn())

    def _insert(self, key: Hashable, value: Any) -> None:
        self._resident[key] = value
        while len(self._resident) > self.capacity_layers:
            self._resident.popitem(last=False)
            self.evictions += 1
        self.peak_resident_layers = max(self.peak_resident_layers,
                                        len(self._resident))
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes())

    @property
    def resident_layers(self) -> int:
        return len(self._resident)

    def resident_bytes(self) -> int:
        return sum(tree_bytes(v) for v in self._resident.values())

    def stats(self) -> Dict[str, int]:
        return {
            "capacity_layers": self.capacity_layers,
            "resident_layers": self.resident_layers,
            "resident_bytes": self.resident_bytes(),
            "peak_resident_layers": self.peak_resident_layers,
            "peak_resident_bytes": self.peak_resident_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "prefetches": self.prefetches,
            "evictions": self.evictions,
        }


class PlanCache(PipelineSharedCache):
    """Bounded FIFO cache of step functions keyed by hetero-plan tuples
    (``core.hetero.HeteroPlan.key()``): the bound on the per-plan programs
    of the straggler -> replan loop. Each distinct plan cuts its own
    shapes, so an unbounded replanner would keep programs without limit;
    this reuses the pipeline-shared cache's FIFO residency and hit/miss
    accounting, with ``capacity_layers`` read as "plans retained". A
    replan oscillating between two plans builds exactly two and then only
    hits. Values are callables, so no bytes are counted."""

    def resident_bytes(self) -> int:
        return 0


def _drop_axes(logical: tuple, which=("fsdp",)) -> tuple:
    out = []
    for entry in logical:
        if entry in which:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a not in which)
            out.append(kept if kept else None)
        else:
            out.append(entry)
    return tuple(out)


def gather_ffn_params(ffn: dict, cfg, mesh, *, d_ff: Optional[int] = None,
                      collectives: str = "fsdp") -> dict:
    """All-gather the fsdp factor of every MoE expert leaf of this rank's
    ``ffn`` shards; the router and the TP factors stay as they are.
    ``collectives="all"`` (the overlap schedule of ``models.lm.
    run_layers``) gathers the TP factor too: the whole expert weights a
    data-centric layer gathers inside its island, the same values. Each
    gather is a global resharding (as the JAX package's sharding
    constraint): its backward keeps this rank's block of the gathered
    leaf's cotangent. Without a mesh it returns ``ffn``'s leaves as they
    are. Pass the result to ``moe_parallel.moe_layer(..., pregathered=
    True)`` ("all": ``pregathered="all"``). ``d_ff``: the experts' global
    hidden width."""
    if collectives not in ("fsdp", "all"):
        raise ValueError(f"collectives {collectives!r}: fsdp | all")
    if mesh is None:
        return dict(ffn)
    from repro_torch.parallel.moe_parallel import (
        MOE_PARAM_LOGICAL,
        _Reshard,
        moe_param_shapes,
    )
    from repro_torch.parallel.sharding import as_axes, physical_spec

    router = ffn["router"]
    shapes = moe_param_shapes(router.shape[1], router.shape[0], d_ff)
    axes = cfg.axes(mesh)
    which = {"fsdp": set(axes["fsdp"])}
    if collectives == "all":
        which["tp"] = set(as_axes(axes["tp"]))
    out = {}
    for name, v in ffn.items():
        logical = MOE_PARAM_LOGICAL.get(name)
        if v is None or logical is None or name == "router":
            out[name] = v
            continue
        spec = physical_spec(shapes[name], logical, cfg, mesh)
        for dim, (lg, entry) in enumerate(zip(logical, spec)):
            got = tuple(a for a in as_axes(entry) if a in which.get(lg, ()))
            if got:
                v = _Reshard.apply(v, mesh, got, dim)
        out[name] = v
    return out


def gathered_layer_bytes(d: int, f: int, e: int, *, glu: bool = True,
                         bytes_per_el: int = 2) -> int:
    """Bytes of ONE layer's fully-gathered expert weights (the unit the
    residency bound multiplies); MLP experts add f32 biases."""
    n_mats = 3 if glu else 2
    total = e * n_mats * d * f * bytes_per_el
    if not glu:
        total += e * (f + d) * 4
    return total


class PagePool(_Snapshot):
    """Free-list allocator + copy-on-write refcounts + residency accounting
    over ``num_pages`` physical pages.

    Physical page 0 is the write sink for inactive slots and is never
    allocated; ``num_pages - 1`` pages are allocatable. Admission is
    two-phase:

      * ``try_reserve(n, group)`` debits a request's WORST-CASE page count
        from the group's free budget up front, so decode can never meet an
        empty pool mid-request;
      * ``alloc(group)`` turns one reserved page into a physical page id
        (a chunk's worth at prefill, one at a decode page boundary);
      * ``release(pages, group, unused_reserved)`` drops one reference per
        page and returns the reservation the caller never converted.

    Refcounts: ``alloc`` hands out a page at refcount 1 owned by its group;
    ``fork`` maps it into another holder at refcount + 1 at no budget cost
    (the prefix index and every borrowing slot hold one reference each);
    ``release`` frees a page only at refcount 0, crediting its OWNER group;
    ``cow`` is the write trigger: writing a refcount > 1 page surrenders
    the shared reference and turns one reservation into a private page.
    Releasing a free page raises.

    ``shares`` split the allocatable pages into per-group budgets (a hetero
    plan's ``page_shares``); pages stay fungible in one free list. A forked
    page stays charged to the group that allocated it until its LAST
    reference dies. Per-group invariant (``assert_consistent``): ``free +
    reserved + in_use == share``.
    """

    def __init__(self, num_pages: int, *, page_bytes: int = 0,
                 shares: Optional[Sequence[int]] = None):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + the sink")
        usable = num_pages - 1
        self.num_pages = num_pages
        self.page_bytes = page_bytes
        self.shares = list(shares) if shares is not None else [usable]
        if any(s < 0 for s in self.shares):
            raise ValueError(f"negative page share: {self.shares}")
        if sum(self.shares) > usable:
            raise ValueError(
                f"shares {self.shares} exceed {usable} allocatable pages")
        self._free_list = list(range(num_pages - 1, 0, -1))
        g = len(self.shares)
        self._free = list(self.shares)
        self._reserved = [0] * g
        self._in_use = [0] * g
        self._ref: Dict[int, int] = {}    # page -> live references
        self._owner: Dict[int, int] = {}  # page -> group charged for it
        self.total_allocs = 0
        self.total_frees = 0
        self.total_forks = 0
        self.total_cow_copies = 0
        self.total_rollbacks = 0
        self.peak_in_use_pages = 0

    # -- admission / allocation ---------------------------------------------

    def _live_ref(self, page: int) -> int:
        """``page``'s refcount, after refusing an id outside the pool."""
        if not 1 <= page < self.num_pages:
            raise ValueError(f"bad page id {page}")
        return self._ref.get(page, 0)

    def try_reserve(self, n: int, group: int = 0) -> bool:
        """Debit ``n`` worst-case pages from ``group``'s budget. False
        leaves the pool untouched."""
        if n < 0:
            raise ValueError(n)
        if self._free[group] < n:
            return False
        self._free[group] -= n
        self._reserved[group] += n
        return True

    def alloc(self, group: int = 0) -> int:
        """Turn one reserved page into a physical page id (>= 1) at
        refcount 1, owned by ``group``."""
        if self._reserved[group] <= 0:
            raise RuntimeError(
                f"group {group} allocating beyond its reservation")
        self._reserved[group] -= 1
        self._in_use[group] += 1
        self.total_allocs += 1
        page = self._free_list.pop()
        self._ref[page] = 1
        self._owner[page] = group
        self.peak_in_use_pages = max(self.peak_in_use_pages,
                                     self.in_use_pages)
        return page

    def fork(self, pages: Sequence[int]) -> None:
        """One more reference on each live page (a borrowing slot or the
        prefix index maps it without a copy); costs no budget. Forking a
        free page or the sink raises."""
        for p in pages:
            if self._live_ref(p) <= 0:
                raise RuntimeError(f"fork of free page {p}")
        for p in pages:
            self._ref[p] += 1
            self.total_forks += 1

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free)."""
        return self._ref.get(page, 0)

    def cow(self, page: int, group: int = 0) -> int:
        """Write trigger: at refcount 1 the caller owns ``page`` and writes
        in place (returned unchanged); above it the caller's reference is
        surrendered and one of its ``group`` reservations becomes a fresh
        page id. The caller copies the payload
        (``launch.steps.make_page_copy_step``) and repoints its table."""
        if self._ref.get(page, 0) <= 0:
            raise RuntimeError(f"cow on free page {page}")
        if self._ref[page] == 1:
            return page
        self._ref[page] -= 1
        self.total_cow_copies += 1
        return self.alloc(group)

    def release(self, pages: Sequence[int], group: int = 0,
                unused_reserved: int = 0) -> None:
        """Drop one reference per page (0-refcount pages return to the free
        list, credited to their owner group) plus ``group``'s reservation
        the caller never converted. Releasing a free page raises before
        anything changes."""
        for p in pages:
            if self._live_ref(p) <= 0:
                raise RuntimeError(
                    f"double release of page {p} (refcount already 0)")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                owner = self._owner.pop(p)
                self._free_list.append(p)
                self._in_use[owner] -= 1
                self._free[owner] += 1
                self.total_frees += 1
        self._reserved[group] -= unused_reserved
        self._free[group] += unused_reserved
        if self._reserved[group] < 0:
            raise RuntimeError(f"group {group} over-released")

    def rollback(self, pages: Sequence[int], group: int = 0) -> None:
        """Return decode-granted pages to the caller's **reservation**, the
        speculative-decoding rollback path: a rolled-back request is still
        live and must be able to re-grow to its admitted worst case, so its
        truncated pages turn from in use back into reserved, never into
        free budget another admission could claim. Only exclusively held
        (refcount 1) pages owned by ``group`` roll back: a shared page is
        prefix content other holders still read. A bad id, a page listed
        twice, a page not in use, shared or foreign raises before any state
        changes."""
        if len(set(pages)) != len(pages):
            raise ValueError(f"rollback lists a page twice: {list(pages)}")
        for p in pages:
            r = self._live_ref(p)
            if r == 0:
                raise RuntimeError(f"rollback of page {p}, which is not in "
                                   f"use")
            if r != 1:
                raise RuntimeError(
                    f"rollback of page {p} at refcount {r} (only "
                    f"exclusively-held decode pages may roll back)")
            if self._owner[p] != group:
                raise RuntimeError(
                    f"rollback of page {p} owned by group "
                    f"{self._owner[p]}, not caller group {group}")
        for p in pages:
            del self._ref[p]
            del self._owner[p]
            self._free_list.append(p)
            self._in_use[group] -= 1
            self._reserved[group] += 1
            self.total_frees += 1
            self.total_rollbacks += 1

    # -- accounting -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return sum(self._free)

    @property
    def in_use_pages(self) -> int:
        return sum(self._in_use)

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved)

    def group_free(self, group: int) -> int:
        return self._free[group]

    def reset_peak(self) -> None:
        """Restart peak tracking from the current residency."""
        self.peak_in_use_pages = self.in_use_pages

    def reshare(self, shares: Sequence[int]) -> None:
        """Rebind the per-group budgets (the elastic-shrink path: after a
        device class drops out the engine re-derives ``page_shares`` over
        the survivors). Legal only on a drained pool: live pages are
        charged to their owner group, which a changed group set would
        orphan."""
        if self.in_use_pages or self.reserved_pages:
            raise RuntimeError(
                f"reshare on a non-drained pool ({self.in_use_pages} live, "
                f"{self.reserved_pages} reserved pages)")
        usable = self.num_pages - 1
        shares = list(shares)
        if any(s < 0 for s in shares):
            raise ValueError(f"negative page share: {shares}")
        if sum(shares) > usable:
            raise ValueError(
                f"shares {shares} exceed {usable} allocatable pages")
        self.shares = shares
        g = len(shares)
        self._free = list(shares)
        self._reserved = [0] * g
        self._in_use = [0] * g
        self._free_list = list(range(self.num_pages - 1, 0, -1))
        self.assert_consistent()

    def assert_consistent(self) -> None:
        for g, share in enumerate(self.shares):
            total = self._free[g] + self._reserved[g] + self._in_use[g]
            if total != share:
                raise AssertionError((g, self._free[g], self._reserved[g],
                                      self._in_use[g], share))
        if len(self._free_list) != self.num_pages - 1 - self.in_use_pages:
            raise AssertionError("free list and in-use count disagree")
        if len(set(self._free_list)) != len(self._free_list):
            raise AssertionError("page on the free list twice")
        if not all(r > 0 for r in self._ref.values()):
            raise AssertionError(f"non-positive refcount: {self._ref}")
        if set(self._ref) != set(self._owner):
            raise AssertionError("refcounted pages and owners disagree")
        if set(self._ref) & set(self._free_list):
            raise AssertionError("page both live and free")
        if len(self._ref) != self.in_use_pages:
            raise AssertionError("live pages and in-use count disagree")
        for g in range(len(self.shares)):
            if self._in_use[g] != sum(1 for o in self._owner.values()
                                      if o == g):
                raise AssertionError(f"group {g}'s in-use count and owners "
                                     f"disagree")

    def stats(self) -> Dict[str, int]:
        return {
            "num_pages": self.num_pages,
            "page_bytes": self.page_bytes,
            "free_pages": self.free_pages,
            "in_use_pages": self.in_use_pages,
            "reserved_pages": self.reserved_pages,
            "shared_pages": sum(1 for r in self._ref.values() if r > 1),
            "peak_in_use_pages": self.peak_in_use_pages,
            "peak_in_use_bytes": self.peak_in_use_pages * self.page_bytes,
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
            "total_forks": self.total_forks,
            "total_cow_copies": self.total_cow_copies,
            "total_rollbacks": self.total_rollbacks,
        }


def page_shares(weights: Sequence[float], usable_pages: int) -> list:
    """Largest-remainder split of the allocatable pages proportional to
    ``weights`` (a hetero plan's Eq. 1 ``token_counts``). Ties in the
    remainders go as numpy's default ``argsort`` orders them, as in the
    JAX package: a stable sort would hand them out differently."""
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"bad share weights {weights}")
    raw = w / w.sum() * usable_pages
    base = np.floor(raw).astype(np.int64)
    order = np.argsort(-(raw - base))
    base[order[: usable_pages - int(base.sum())]] += 1
    assert base.sum() == usable_pages
    return [int(v) for v in base]


# ---------------------------------------------------------------------------
# radix prefix index
# ---------------------------------------------------------------------------

class _TrieNode:
    """One page-granular edge of the prefix trie: ``key`` is the tuple of
    ``page_size`` token ids the node's page holds, ``page`` the physical
    page id the index keeps one ``PagePool`` reference on."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixIndex(_Snapshot):
    """Radix prefix index keyed on token ids at page granularity: admission
    matches the longest cached prefix of a prompt against whole pages
    already resident in the pool and maps them into the new slot's page
    table at refcount + 1 instead of prefilling them again.

    Only FULL prompt pages are indexed, once the prompt that wrote them has
    finished prefill, so cached content is immutable (decode writes land
    past the prompt). K/V rows depend only on the token prefix and the
    absolute position, so equal chunks at equal depths share bit for bit;
    int8 pools share their scale rows through the same page id.

    Every node holds ONE pool reference on its page. ``evict_lru`` frees
    the least recently used leaf at refcount 1 (cached, borrowed by no
    slot); interior nodes and borrowed pages are pinned.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(page_size)
        self.page_size = page_size
        self.root = _TrieNode(None, 0, None)
        self._clock = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        """Number of cached pages (trie nodes below the root)."""
        return sum(1 for _ in self.pages())

    def _chunks(self, tokens, max_pages: int) -> list:
        p = self.page_size
        limit = min(max_pages, len(tokens) // p)
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(limit)]

    def match(self, tokens, max_pages: int) -> list:
        """Physical page ids of the leading whole-page chunks of ``tokens``
        in the trie, at most ``max_pages`` (the engine caps at ``(plen -
        1) // page_size`` so one suffix token is always left to prefill).
        Bumps the LRU clocks along the path; the caller forks the pages
        before anything can evict them."""
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        node, pages = self.root, []
        self._clock += 1
        for key in self._chunks(tokens, max_pages):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        self.hit_tokens += len(pages) * self.page_size
        return pages

    def insert(self, tokens, pages: Sequence[int], pool: PagePool) -> int:
        """Index the leading ``len(pages)`` whole-page chunks of ``tokens``
        under ``pages``, forking one pool reference per NEW node (chunks
        already cached keep their page). Returns the pages newly indexed."""
        node = self.root
        self._clock += 1
        added = 0
        for key, page in zip(self._chunks(tokens, len(pages)), pages):
            child = node.children.get(key)
            if child is None:
                pool.fork([page])
                child = _TrieNode(key, page, node)
                child.last_used = self._clock
                node.children[key] = child
                added += 1
            node = child
        return added

    def evict_lru(self, pool: PagePool) -> bool:
        """Release the least recently used evictable page (a refcount-1
        leaf) to the pool. False when nothing is evictable."""
        best = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if not child.children and pool.refcount(child.page) == 1:
                    if best is None or child.last_used < best.last_used:
                        best = child
                stack.append(child)
        if best is None:
            return False
        pool.release([best.page])
        del best.parent.children[best.key]
        self.evictions += 1
        return True

    def pages(self):
        """Yield the page id of every trie node, one pool reference each
        (``PagedServer.assert_page_invariants`` counts them as holders)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                yield child.page
                stack.append(child)

    def clear(self, pool: PagePool) -> int:
        """Drop every evictable cached reference, leaves first; pages still
        borrowed by live slots stay. Returns the pages dropped."""
        dropped = 0
        while self.evict_lru(pool):
            dropped += 1
        return dropped

    def stats(self) -> Dict[str, int]:
        return {
            "cached_pages": len(self),
            "lookups": self.lookups,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "evictions": self.evictions,
        }
