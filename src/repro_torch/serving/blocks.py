"""Page/block bookkeeping for the paged serving cache (host-side control
plane; no jax here).

The pools are fixed device allocations (see ``paged_cache``); this
module hands out ids into them and tracks which request owns what. The
scheduler runs one :class:`BlockAllocator` per index domain: the *paged*
domain, where full-KV and MLA-latent requests take
``ceil(len / page_size)`` growable pages tracked in a per-request
:class:`BlockTable`, and the *slot* domain (page_size 1), where
constant-size states — the paper's O(m d) SRF state, the SSD state, the
enc-dec encoder memory — take exactly one slot for the request's whole
lifetime. A mixed-geometry request (hybrid, enc-dec) owns both.

Pages are REFCOUNTED: ``alloc`` hands a page out at refcount 1,
``share`` adds owners (the prefix cache and every request reusing a
cached prefix hold one reference each), and ``free`` only returns a
page to the free list when its last reference drops. A shared page is
read-only by contract — a writer must COW-fork it first (see
``serving/prefix/cow.py``); the allocator itself only counts.

Id 0 is reserved in both domains as the *null page/slot*: padded batch
rows point their block tables (and slot vector) at it, so scatters from
inactive rows land in scratch memory instead of corrupting live
requests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

NULL_PAGE = 0


class BlockAllocator:
    """Free-list page allocator over a fixed pool of ``num_pages`` pages,
    with per-page reference counts for prefix sharing.

    Invariants (tested):
      * a page is never handed out twice while allocated
      * ``free`` decrements exactly one reference; the page returns to
        the pool only at refcount 0, and freeing a page with no live
        reference RAISES (double free / foreign page) instead of
        silently re-listing it — re-listing would let the same page be
        handed to two requests, which is silent cache corruption
      * page ``NULL_PAGE`` is never allocated and never refcounted
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop -> 1,2,..
        self._ref: Dict[int, int] = {}

    @property
    def _allocated(self) -> set:
        """Set of pages with at least one live reference (compat view —
        pre-refcount callers and tests read this)."""
        return set(self._ref)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._ref)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts over all allocated pages — the conservation
        quantity for shared pages: equals the number of (owner, page)
        edges across request tables, the prefix cache, and transient
        pins."""
        return sum(self._ref.values())

    def refcount(self, pg: int) -> int:
        return self._ref.get(pg, 0)

    def is_shared(self, pg: int) -> bool:
        """More than one live owner: writing requires a COW fork."""
        return self._ref.get(pg, 0) > 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None if the pool cannot satisfy."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._ref[pg] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one reference per page (a new owner of already-allocated
        pages: a prefix-cache entry, or a request attaching to one)."""
        for pg in pages:
            if pg not in self._ref:
                raise ValueError(f"share of unallocated page {pg}")
            self._ref[pg] += 1

    def free(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages whose LAST reference drops
        return to the free list (returned for the caller's bookkeeping).
        Raises on a page with no live reference — a double free must
        never silently re-list a page another owner still reads."""
        released: List[int] = []
        for pg in pages:
            n = self._ref.get(pg)
            if n is None:
                raise ValueError(f"double free / foreign page {pg}")
            if n == 1:
                del self._ref[pg]
                self._free.append(pg)
                released.append(pg)
            else:
                self._ref[pg] = n - 1
        return released

    def defrag_plan(self) -> Dict[int, int]:
        """Compaction map {old_page: new_page} packing live pages into the
        lowest indices. The caller must apply the map to its block tables
        AND the prefix cache AND copy the pool rows
        (``paged_cache.apply_moves``) before using the allocator again;
        this method re-labels internal state (refcounts travel with the
        page) only."""
        live = sorted(self._ref)
        targets = range(1, len(live) + 1)
        moves = {old: new for old, new in zip(live, targets) if old != new}
        if moves:
            self._ref = {moves.get(pg, pg): n for pg, n in self._ref.items()}
            self._free = [p for p in range(self.num_pages - 1, 0, -1)
                          if p not in self._ref]
        return moves


@dataclass
class BlockTable:
    """Per-request page list + logical length (tokens written)."""
    pages: List[int] = field(default_factory=list)
    length: int = 0

    def padded(self, width: int) -> List[int]:
        """Fixed-width view for the device block-table tensor."""
        if len(self.pages) > width:
            raise ValueError(f"{len(self.pages)} pages > table width {width}")
        return self.pages + [NULL_PAGE] * (width - len(self.pages))

    def pages_needed(self, new_length: int, page_size: int) -> int:
        """How many NEW pages must be allocated to grow to ``new_length``.
        (Paged-domain only: constant-size states live in the slot domain
        and never grow — see the scheduler's plan handling.)"""
        want = -(-new_length // page_size)        # ceil
        return max(0, want - len(self.pages))
