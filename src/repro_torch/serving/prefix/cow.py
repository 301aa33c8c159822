"""Copy-on-write glue between the prefix trie and the refcounted
allocator.

A cached prefix maps to pages with allocator refcount > 1 (the cache
holds one reference, every attached request another). Shared pages are
READ-ONLY by contract; the device step never checks — the host
guarantees no write position ever lands in a shared page, via exactly
two fork sites:

* **Admission fork** (:func:`plan_match`): when the matched token count
  ``m`` is not page-aligned, the boundary page holds ``m % page_size``
  reusable KV rows plus stale tail rows the request will overwrite as
  its suffix prefills. The request gets a private copy: its first
  freshly allocated page becomes the fork destination, the cached page
  stays pinned (one extra ref) until the engine's device copy retires.

* **Decode fork** (:func:`decode_fork_index`): a donor's own last
  partial prompt page becomes shared the moment its prompt is inserted
  into the cache; the donor's first decode write would land in it. The
  scheduler forks it before the write (``grow_for_decode``).

Both sites batch their device copies through
``paged_cache.copy_page_rows`` — one gather-then-scatter, so a fork
destination recycled from a page freed in the same scheduler round can
never be read after being clobbered.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Fork:
    """One pending device page copy ``src -> dst``. ``pinned_src`` marks
    an admission fork, where the lookup holds an extra reference on
    ``src`` that the engine must drop AFTER the copy retires."""
    src: int
    dst: int
    pinned_src: bool = False


@dataclass
class PrefixMatch:
    """A pinned prefix-cache hit, held between lookup and admission.

    ``pages`` are the full shared pages (refcount bumped once each —
    ownership transfers to the request's block table at admission, whose
    release decrefs them uniformly). ``fork_src`` is the pinned boundary
    page when ``tokens`` is unaligned. ``payload``/``payload_tokens``
    carry a donor's constant-state snapshot for slot-bearing plans.
    """
    ns: int
    tokens: int
    pages: List[int] = field(default_factory=list)
    fork_src: Optional[int] = None
    payload: Optional[object] = None
    payload_tokens: int = 0

    @property
    def pinned(self) -> List[int]:
        """Every page this match holds a reference on."""
        return self.pages + ([self.fork_src]
                             if self.fork_src is not None else [])


def plan_match(nodes, m: int, page_size: int):
    """Split a capped match of ``m`` tokens over the walked trie
    ``nodes`` into (full shared pages, boundary fork source or None).
    ``nodes`` must cover at least ``ceil(m / page_size)`` pages (the
    walk matched >= m tokens)."""
    full = m // page_size
    shared = [nd.page for nd in nodes[:full]]
    fork_src = nodes[full].page if m % page_size else None
    return shared, fork_src


def decode_fork_index(alloc, table_pages: List[int], pos: int,
                      page_size: int) -> Optional[int]:
    """Index into ``table_pages`` of the page that must be COW-forked
    before writing token position ``pos``, or None when the write target
    is exclusively owned (or does not exist yet — growth, not a fork)."""
    idx = pos // page_size
    if idx < len(table_pages) and alloc.is_shared(table_pages[idx]):
        return idx
    return None


def assert_writable(alloc, table_pages: List[int], start: int, n: int,
                    page_size: int) -> None:
    """Debug guard for the read-only contract: every page a write of
    ``n`` tokens from position ``start`` touches must have exactly one
    owner. Cheap (a dict lookup per touched page), so the engine runs it
    on every batch row while a prefix cache is attached."""
    for idx in range(start // page_size,
                     min(-(-(start + n) // page_size), len(table_pages))):
        pg = table_pages[idx]
        if alloc.refcount(pg) != 1:
            raise AssertionError(
                f"write into page {pg} (table idx {idx}) with refcount "
                f"{alloc.refcount(pg)} — shared pages are read-only; "
                "a COW fork was missed")
