"""Paged decode-cache pool and prefix cache: the host-side bookkeeping.

The port's own copy of the JAX package's ``launch/paging.py`` (pure numpy
and the standard library, no model compute), so that the port imports
nothing of the JAX package.

The contiguous engine gives every slot a fixed ``(max_seq, ...)`` cache
row, so short requests strand memory and identical prompts prefill once
a request.  The paged engine (``launch/engine.py``) keeps instead:

* :class:`PagePool`: a free-list allocator over fixed-size pages of the
  sequence axis, with per-page refcounts and the per-slot page table.  One
  page id addresses the same physical page in every arena (all layers, K
  and V).  Page 0 is the reserved zero page: a table entry of 0 means
  unmapped, and a gather through it reads zeros, which is what a fresh
  contiguous row holds.
* :class:`PrefixCache`: an exact-prompt map from prompt bytes to the pages
  that hold its prefilled keys and values, the constant-size recurrent
  state rows and the prompt's last-position logits.  A hit maps the shared
  pages into the new slot without a copy; the refcounts make the sharing
  copy-on-write (``ServeEngine._ensure_write_pages`` copies a page with
  other referents before a decode write lands on it).  Entries are LRU and
  evicted when the pool runs dry.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: The reserved all-zero page; table entries of 0 mean "unmapped".
ZERO_PAGE = 0


class PagePool:
    """Free-list page allocator + per-slot page table + per-page refcounts.

    Invariants (``check_invariants``; tests/test_torch_paging.py):

    * ``refcount[p]`` equals the number of live references to page ``p``:
      page-table entries plus external (prefix-cache entry) references.
    * A page is on the free list iff its refcount is 0; it is handed out
      again only after every referent dropped it (no use-after-free).
    * ``refcount[ZERO_PAGE]`` is pinned ≥ 1 forever — the zero page is
      never allocated, never freed, and never written by the host.
    * Allocation order is deterministic (LIFO free list), so runs replay
      bitwise.
    """

    def __init__(self, num_pages: int, n_slots: int, pages_per_slot: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.refcount = np.zeros(num_pages, np.int64)
        self.refcount[ZERO_PAGE] = 1          # pinned: never allocatable
        # LIFO free list, lowest ids handed out first (deterministic).
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.table = np.zeros((n_slots, pages_per_slot), np.int32)
        self.page_allocs = 0
        self.peak_in_use = 0

    # -- allocator ---------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages currently referenced (excluding the reserved zero page)."""
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages off the free list (refcount 1 each), or None
        when the pool can't cover the request (caller evicts and retries)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            assert self.refcount[pid] == 0, f"freed page {pid} had refs"
            self.refcount[pid] = 1
        self.page_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return ids

    def incref(self, pid: int) -> None:
        assert pid != ZERO_PAGE and self.refcount[pid] > 0, \
            f"incref of dead/zero page {pid}"
        self.refcount[pid] += 1

    def decref(self, pid: int) -> None:
        """Drop one reference; a page hitting refcount 0 returns to the
        free list (a double free asserts instead of corrupting it)."""
        assert pid != ZERO_PAGE, "decref of the reserved zero page"
        assert self.refcount[pid] > 0, f"double free of page {pid}"
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)

    # -- page table --------------------------------------------------------

    def map_slot(self, slot: int, ids: Sequence[int], *,
                 owned: bool) -> None:
        """Map ``ids`` into table entries ``[0, len(ids))`` of ``slot``.

        ``owned=True`` transfers freshly allocated pages (refcount already
        1); ``owned=False`` shares existing pages (prefix hit) and increfs
        each.  The slot's row must be clear (engine retires before reuse).
        """
        assert not self.table[slot].any(), f"slot {slot} table not clear"
        for j, pid in enumerate(ids):
            if not owned:
                self.incref(pid)
            self.table[slot, j] = pid

    def map_index(self, slot: int, j: int, pid: int) -> None:
        """Map one freshly allocated page at table index ``j``."""
        assert self.table[slot, j] == ZERO_PAGE
        self.table[slot, j] = pid

    def remap(self, slot: int, j: int, pid: int) -> int:
        """Replace the mapping at index ``j`` (COW: new page already owned);
        drops the old page's reference and returns its id."""
        old = int(self.table[slot, j])
        assert old != ZERO_PAGE
        self.table[slot, j] = pid
        self.decref(old)
        return old

    def clear_slot(self, slot: int) -> None:
        """Unmap every page of ``slot`` (decref each; refcount-0 pages
        return to the free list — entry-shared pages survive)."""
        for j in range(self.pages_per_slot):
            pid = int(self.table[slot, j])
            if pid != ZERO_PAGE:
                self.decref(pid)
                self.table[slot, j] = ZERO_PAGE

    def slot_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self.table[slot] if p != ZERO_PAGE]

    def check_invariants(self, external_refs: Dict[int, int]) -> None:
        """Assert refcounts == table refs + ``external_refs`` and the free
        list holds exactly the refcount-0 pages (test helper)."""
        counts = np.zeros(self.num_pages, np.int64)
        counts[ZERO_PAGE] = 1
        for pid in self.table.ravel():
            if pid != ZERO_PAGE:
                counts[pid] += 1
        for pid, n in external_refs.items():
            counts[pid] += n
        assert (counts == self.refcount).all(), \
            f"refcount drift: {np.nonzero(counts != self.refcount)[0]}"
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages on free list"
        for pid in range(1, self.num_pages):
            assert (pid in free) == (self.refcount[pid] == 0)


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt: the pages holding its prefilled keys and values,
    the constant-size recurrent state rows (rwkv, mamba: no positional axis, so
    they ride the prefix cache, not the page pool), and the prompt's
    last-position logits (so a hit skips the prefill and samples the first
    token from the stored row, bit for bit)."""
    page_ids: Tuple[int, ...]
    state: Any                   # tree of (n_periods, 1, ...) rows, or None
    logits: Any                  # (V,) f32
    plen: int


class PrefixCache:
    """Exact-prompt prefix cache at page granularity, LRU-evicted.

    Keys are the prompt token bytes; a hit returns the entry whose pages are
    then mapped (shared, refcounted) into the admitted slot.  Registration
    increfs every page the entry references; eviction drops them — the
    invariant "refcount == number of live references" is what
    ``PagePool.check_invariants`` asserts.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.queries = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def get(self, key: bytes) -> Optional[PrefixEntry]:
        """Look up a prompt; a hit refreshes its LRU position."""
        self.queries += 1
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
        return entry

    def peek(self, key: bytes) -> Optional[PrefixEntry]:
        """Stats-free lookup (no query/hit counting, no LRU refresh) — for
        same-batch duplicates that were only just registered."""
        return self._entries.get(key)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0

    def register(self, key: bytes, page_ids: Sequence[int], state,
                 logits, plen: int) -> PrefixEntry:
        """Record a freshly prefilled prompt; increfs every page."""
        assert key not in self._entries, "prompt already registered"
        for pid in page_ids:
            self.pool.incref(pid)
        entry = PrefixEntry(tuple(int(p) for p in page_ids), state, logits,
                            plen)
        self._entries[key] = entry
        return entry

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (decref its pages); False when
        there is nothing left to evict."""
        if not self._entries:
            return False
        _, entry = self._entries.popitem(last=False)
        for pid in entry.page_ids:
            self.pool.decref(pid)
        return True

    def external_refs(self) -> Dict[int, int]:
        """page id → number of entry references (invariant-check helper)."""
        refs: Dict[int, int] = {}
        for entry in self._entries.values():
            for pid in entry.page_ids:
                refs[pid] = refs.get(pid, 0) + 1
        return refs
