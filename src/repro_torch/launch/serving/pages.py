"""Physical KV-page allocator for one batch shard.

Every batch shard (one (data, z) mesh coordinate) owns an independent
pool of ``n_pages`` physical pages per attention layer; requests sharded
onto it draw pages from this free list and their page tables hold the
resulting shard-LOCAL ids. Page 0 is the reserved **null page**: it is
never handed out, and the paged attention kernel routes every invalid
write (chunk padding, idle slots) to it — so a table entry of 0 always
means "unallocated" and stale data there is provably never read
(masked scores contribute exact zeros; see docs/serving.md).

tests/test_serving.py churns admit/evict cycles against the invariants
``check`` pins: conservation (free + used == n_pages - 1), no double
allocation, null page never allocated, no foreign frees.
"""
from __future__ import annotations

from typing import List


class PageAllocator:
    """LIFO free-list allocator over pages ``1 .. n_pages - 1``."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"a pool needs >= 2 pages (one reserved null + one "
                f"allocatable), got {n_pages}")
        self.n_pages = n_pages
        # LIFO keeps recently-freed (cache-warm) pages hot
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._used: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def alloc(self):
        """One free page id, or None when the pool is exhausted (the
        scheduler then preempts — it never fails hard on memory)."""
        if not self._free:
            return None
        p = self._free.pop()
        self._used.add(p)
        return p

    def free(self, pages) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("null page 0 is reserved and never "
                                 "allocated; freeing it is a table bug")
            if p not in self._used:
                raise ValueError(f"double/foreign free of page {p}")
            self._used.remove(p)
            self._free.append(p)

    def check(self) -> None:
        """Assert the pool invariants (test hook)."""
        assert 0 not in self._used and 0 not in self._free
        assert not self._used.intersection(self._free)
        assert len(self._free) + len(self._used) == self.n_pages - 1, \
            (len(self._free), len(self._used), self.n_pages)
