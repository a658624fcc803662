"""Serving page pool (counterpart of ``repro.parallel.cache.PagePool``).

Host-side free list and residency accounting over the shared KV
page pool of ``models.lm.init_paged_cache``, with the speculative
decoding ``rollback``. Per-group page shares (hetero plans,
``page_shares``), the copy-on-write half (``fork``/``cow``) and elastic
``reshare`` belong to later slices and are not ported: the port's pool is
one budget.
"""
from __future__ import annotations

from typing import Dict, Sequence, Set


class PagePool:
    """Free-list allocator over ``num_pages`` physical pages.

    Physical page 0 is the write sink for inactive slots and is never
    allocated. Admission is two-phase: ``try_reserve(n)`` debits a
    request's worst-case page count from the budget up front, so ``alloc()``
    (a chunk's worth at prefill, one page at a decode boundary) can never
    fail; ``release`` returns pages and any unconverted reservation.
    Invariant (``assert_consistent``): ``free + reserved + in_use ==
    num_pages - 1``.
    """

    def __init__(self, num_pages: int, *, page_bytes: int = 0):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + the sink")
        self.num_pages = num_pages
        self.page_bytes = page_bytes
        self._free_list = list(range(num_pages - 1, 0, -1))
        self._free = num_pages - 1        # budget not yet reserved
        self._reserved = 0                # reserved, not yet allocated
        self._live: Set[int] = set()      # allocated pages
        self.total_allocs = 0
        self.total_frees = 0
        self.total_rollbacks = 0
        self.peak_in_use_pages = 0

    def try_reserve(self, n: int) -> bool:
        """Debit ``n`` worst-case pages from the budget. False leaves the
        pool untouched."""
        if n < 0:
            raise ValueError(n)
        if self._free < n:
            return False
        self._free -= n
        self._reserved += n
        return True

    def alloc(self) -> int:
        """Turn one reserved page into a physical page id (>= 1)."""
        if self._reserved <= 0:
            raise RuntimeError("allocating beyond the reservation")
        self._reserved -= 1
        self.total_allocs += 1
        page = self._free_list.pop()
        self._live.add(page)
        self.peak_in_use_pages = max(self.peak_in_use_pages,
                                     self.in_use_pages)
        return page

    def release(self, pages: Sequence[int], unused_reserved: int = 0) -> None:
        """Return pages to the free list, plus any reservation the caller
        never converted. Releasing a free page raises."""
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            if p not in self._live:
                raise RuntimeError(f"double release of page {p}")
        for p in pages:
            self._live.remove(p)
            self._free_list.append(p)
            self._free += 1
            self.total_frees += 1
        if unused_reserved > self._reserved:
            raise RuntimeError("over-released reservation")
        self._reserved -= unused_reserved
        self._free += unused_reserved

    def rollback(self, pages: Sequence[int]) -> None:
        """Return decode-granted pages to the caller's **reservation**, the
        speculative-decoding rollback path. A rolled-back request is still
        live and must be able to re-grow to its admitted worst-case length,
        so its truncated pages turn from in use back into reserved, never
        into free budget another admission could claim. A bad page id, a
        page not in use or one listed twice raises before any state
        changes."""
        if len(set(pages)) != len(pages):
            raise ValueError(f"rollback lists a page twice: {list(pages)}")
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            if p not in self._live:
                raise RuntimeError(f"rollback of page {p}, which is not in "
                                   f"use")
        for p in pages:
            self._live.remove(p)
            self._free_list.append(p)
            self._reserved += 1
            self.total_frees += 1
            self.total_rollbacks += 1

    @property
    def free_pages(self) -> int:
        return self._free

    @property
    def in_use_pages(self) -> int:
        return len(self._live)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    def assert_consistent(self) -> None:
        usable = self.num_pages - 1
        if self._free + self._reserved + self.in_use_pages != usable:
            raise AssertionError((self._free, self._reserved,
                                  self.in_use_pages, usable))
        if len(self._free_list) != usable - self.in_use_pages:
            raise AssertionError("free list and in-use count disagree")
        if len(set(self._free_list)) != len(self._free_list):
            raise AssertionError("page on the free list twice")
        if self._live & set(self._free_list):
            raise AssertionError("page both live and free")

    def stats(self) -> Dict[str, int]:
        return {
            "num_pages": self.num_pages,
            "page_bytes": self.page_bytes,
            "free_pages": self.free_pages,
            "in_use_pages": self.in_use_pages,
            "reserved_pages": self.reserved_pages,
            "peak_in_use_pages": self.peak_in_use_pages,
            "peak_in_use_bytes": self.peak_in_use_pages * self.page_bytes,
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
            "total_rollbacks": self.total_rollbacks,
        }
