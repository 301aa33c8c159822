"""The prefix cache: radix trie + refcounted pages + metrics, one per
engine.

Lifecycle of a cached prefix (the paper's move — share the stored
object, pay only the delta):

* **insert** — when a request finishes prefill, its prompt pages (all of
  them, including an unaligned tail page) go into the trie; the cache
  takes ONE allocator reference per newly added page, so the pages
  survive the donor finishing. Slot-bearing plans (hybrid/ssd) attach a
  snapshot of the donor's constant-state slot to the final node — KV
  pages alone cannot resume an SSM.
* **lookup** — at admission the scheduler walks the trie with the new
  prompt. A match of ``m`` tokens (capped at ``plen - 1``: at least one
  token must prefill to produce first-token logits) pins ``m // P`` full
  pages (shared read-only into the request's table) plus, when ``m`` is
  unaligned, the boundary page as a COW-fork source. Slot-bearing plans
  only hit at a donor's exact state point (``payload_tokens``) — pages
  without the matching slot state are useless to them.
* **release / eviction** — dropping a trie leaf drops the cache's one
  reference; the allocator frees the page only when no request still
  holds it. LRU leaves go first; leaves whose page is still shared with
  a running request are pinned (evicting them frees nothing). An
  optional byte budget (``cache_bytes``) bounds the cache's footprint;
  allocator pressure (admission/growth failures) evicts on demand.

The cache is host-side bookkeeping only — device copies (COW forks,
payload restores) are the engine's job.

Port: a copy of ``repro.serving.prefix.cache`` (host Python; the
port keeps its own copy and imports nothing of ``repro``), except
that payload bytes are counted by the port's snapshot objects
instead of from jax pytrees.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import spans as obs_spans

from . import cow
from .chunk import ChunkConfig
from .trie import RadixTrie, TrieNode


@dataclass(frozen=True)
class PrefixConfig:
    """Engine-level knobs for the prefix subsystem. ``cache_bytes=0``
    means unbounded (the pool's page capacity is the only limit)."""
    enabled: bool = True
    cache_bytes: int = 0
    chunk: ChunkConfig = field(default_factory=ChunkConfig)


class PrefixCache:
    """One engine's prefix cache over its paged-domain allocator."""

    def __init__(self, alloc, page_size: int, page_bytes: int,
                 cfg: Optional[PrefixConfig] = None, metrics=None,
                 labels: Optional[Dict[str, str]] = None, spans=None):
        self.alloc = alloc
        self.page_size = page_size
        self.page_bytes = max(int(page_bytes), 1)
        self.cfg = cfg or PrefixConfig()
        self.spans = spans if spans is not None else obs_spans.NOOP
        self.trie = RadixTrie(page_size)
        self._payload_bytes: Dict[int, int] = {}     # node id -> bytes
        # invoked whenever the cache changes the ALLOCATOR's free/used
        # state (eviction, releasing pins) — the scheduler hooks its
        # gauge sync here so `sched_free_pages` never drifts from the
        # allocator while the cache breathes
        self.on_pool_change = lambda: None
        self._init_metrics(metrics, labels)

    # -- metrics -------------------------------------------------------------

    def _init_metrics(self, metrics, labels) -> None:
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        labels = dict(labels or {"engine": "-"})
        ln = tuple(labels)
        c = lambda name, help: self.metrics.counter(  # noqa: E731
            name, help, ln).labels(**labels)
        g = lambda name, help: self.metrics.gauge(    # noqa: E731
            name, help, ln).labels(**labels)
        self._c_lookups = c("prefix_lookups_total", "prefix-cache lookups")
        self._c_hits = c("prefix_hits_total", "lookups that matched >= 1 "
                         "token (and pinned pages)")
        self._c_hit_tokens = c("prefix_hit_tokens_total",
                               "prompt tokens served from cached pages "
                               "instead of prefill")
        self._c_evictions = c("prefix_evictions_total",
                              "trie leaves evicted (LRU / pressure)")
        self._c_inserted = c("prefix_inserted_pages_total",
                             "pages newly referenced by the cache")
        self._g_bytes = g("prefix_cache_bytes", "bytes the cache currently "
                          "references (pages + slot-state payloads)")
        self._g_pages = g("prefix_cache_pages", "pages the cache holds a "
                          "reference on")
        self._g_hit_rate = g("prefix_hit_rate", "hits / lookups over the "
                             "engine's lifetime (derived gauge)")
        # per-tenant attribution: the existing unlabelled-by-tenant
        # counters stay the engine-level truth; these children break
        # the same probes down by namespace for fairness accounting
        self._labels = labels
        tl = tuple(labels) + ("tenant",)
        self._c_t_lookups = self.metrics.counter(
            "prefix_tenant_lookups_total",
            "prefix-cache lookups by tenant namespace", tl)
        self._c_t_hits = self.metrics.counter(
            "prefix_tenant_hits_total",
            "prefix-cache hits by tenant namespace", tl)
        self._tenant_children: Dict[str, tuple] = {}
        self._sync_gauges()

    def _tenant(self, tenant: str):
        pair = self._tenant_children.get(tenant)
        if pair is None:
            kw = dict(self._labels, tenant=tenant)
            pair = (self._c_t_lookups.labels(**kw),
                    self._c_t_hits.labels(**kw))
            self._tenant_children[tenant] = pair
        return pair

    def _update_hit_rate(self) -> None:
        lookups = self._c_lookups.value()
        if lookups:
            self._g_hit_rate.set(self._c_hits.value() / lookups)

    def _sync_gauges(self) -> None:
        self._g_bytes.set(self.bytes)
        self._g_pages.set(self.pages)

    # -- introspection -------------------------------------------------------

    @property
    def pages(self) -> int:
        """Pages the cache references (trie nodes are 1:1 with pages)."""
        return self.trie.n_nodes

    @property
    def bytes(self) -> int:
        return (self.trie.n_nodes * self.page_bytes
                + sum(self._payload_bytes.values()))

    def page_ids(self) -> List[int]:
        return self.trie.pages()

    # -- lookup / insert -----------------------------------------------------

    def lookup(self, ns: int, tokens, want_state: bool = False,
               tenant: str = "-", uid: Optional[int] = None
               ) -> Optional[cow.PrefixMatch]:
        """Longest usable match for a prompt; pins every returned page
        (one allocator reference each) until admission transfers or
        :meth:`release` drops them. Returns None on a miss."""
        self._c_lookups.inc()
        t_lookups, t_hits = self._tenant(tenant)
        t_lookups.inc()
        plen = len(tokens)
        raw = self.trie.walk(ns, tokens)
        m, payload, ptoks = self._usable(raw, plen, want_state)
        if m <= 0:
            self._update_hit_rate()
            return None
        shared, fork_src = cow.plan_match(raw.nodes, m, self.page_size)
        self.alloc.share(shared + ([fork_src] if fork_src is not None
                                   else []))
        self._c_hits.inc()
        t_hits.inc()
        self._c_hit_tokens.inc(m)
        self._update_hit_rate()
        self.spans.instant("prefix_hit", uid=uid, tokens=m,
                           pages=len(shared), tenant=tenant)
        return cow.PrefixMatch(ns=ns, tokens=m, pages=shared,
                               fork_src=fork_src, payload=payload,
                               payload_tokens=ptoks)

    def peek(self, ns: int, tokens, want_state: bool = False) -> int:
        """Matched token count WITHOUT pinning or LRU touching — the
        router's prefix-affinity probe (it peeks every replica; touching
        would distort every replica's LRU order identically, i.e. pure
        noise)."""
        raw = self.trie.walk(ns, tokens, touch=False)
        m, _, _ = self._usable(raw, len(tokens), want_state)
        return max(m, 0)

    @staticmethod
    def _usable(raw, plen: int, want_state: bool):
        """Cap a raw walk at the plan's usable match: at most ``plen - 1``
        tokens (>= 1 token must prefill for first-token logits), and for
        slot-bearing plans exactly a donor's state point — shared KV
        without the matching constant state would silently skip the SSM
        updates for those tokens."""
        if want_state:
            cands = [(t, p) for t, p in raw.payloads if t <= plen - 1]
            if not cands:
                return 0, None, 0
            t, p = max(cands)
            return t, p, t
        return min(raw.tokens, plen - 1), None, 0

    def release(self, match: cow.PrefixMatch) -> None:
        """Unpin a match that was not admitted (allocation failed)."""
        self.alloc.free(match.pinned)
        self.on_pool_change()

    def release_fork(self, src: int) -> None:
        """Drop the admission-fork pin after the device copy retired."""
        self.alloc.free([src])
        self.on_pool_change()

    def insert(self, ns: int, tokens, pages: List[int],
               payload=None, payload_tokens: int = 0) -> List[int]:
        """Cache a fully prefilled prompt; returns the pages the cache
        newly references (it ``share``s each — existing nodes on the
        path keep their canonical pages and cost nothing; the caller
        checks membership to learn whether its tail-copy page was
        adopted)."""
        new_pages, node = self.trie.insert(ns, tokens, pages)
        if new_pages:
            self.alloc.share(new_pages)
            self._c_inserted.inc(len(new_pages))
            self.spans.instant("prefix_insert", pages=len(new_pages),
                               tokens=len(tokens))
        if payload is not None and node.payload is None:
            node.payload = payload
            node.payload_tokens = payload_tokens
            self._payload_bytes[id(node)] = _payload_nbytes(payload)
        self.enforce_budget()
        self._sync_gauges()
        return new_pages

    # -- eviction ------------------------------------------------------------

    def _drop_leaf(self, leaf: TrieNode) -> int:
        pg = self.trie.remove(leaf)
        self._payload_bytes.pop(id(leaf), None)
        self._c_evictions.inc()
        self.spans.instant("prefix_evict")
        return len(self.alloc.free([pg]))

    def evict_for(self, n: int) -> int:
        """Allocator pressure: free at least ``n`` pages back to the
        pool by dropping LRU leaves whose page has no other owner
        (pinned leaves free nothing — skipped). Returns pages actually
        freed; dropping a leaf can expose its parent, so the scan
        repeats until satisfied or dry."""
        released, progress = 0, True
        while released < n and progress:
            progress = False
            for leaf in self.trie._leaves_lru():
                if self.alloc.is_shared(leaf.page):
                    continue
                released += self._drop_leaf(leaf)
                progress = True
                if released >= n:
                    break
        if released:
            self._sync_gauges()
            self.on_pool_change()
        return released

    def enforce_budget(self) -> int:
        """LRU-evict unpinned leaves until within ``cache_bytes``.
        Pinned leaves are never evicted (the running request holds the
        page anyway — dropping the cache reference frees nothing and
        only destroys reuse), so the budget can transiently overshoot
        while donors run; it converges as they finish."""
        if self.cfg.cache_bytes <= 0:
            return 0
        dropped, progress = 0, True
        while self.bytes > self.cfg.cache_bytes and progress:
            progress = False
            for leaf in self.trie._leaves_lru():
                if self.alloc.is_shared(leaf.page):
                    continue
                self._drop_leaf(leaf)
                dropped += 1
                progress = True
                if self.bytes <= self.cfg.cache_bytes:
                    break
        if dropped:
            self._sync_gauges()
            self.on_pool_change()
        return dropped

    def drop_all(self) -> int:
        """Drop EVERY cache reference (pinned or not) — teardown/tests:
        after a drain the pool must return to zero used pages once the
        cache lets go."""
        dropped, progress = 0, True
        while progress:
            progress = False
            for leaf in self.trie._leaves_lru():
                self._drop_leaf(leaf)
                dropped += 1
                progress = True
        self._sync_gauges()
        self.on_pool_change()
        return dropped

    # -- maintenance ---------------------------------------------------------

    def remap(self, moves: Dict[int, int]) -> None:
        """Defrag moved pages; the trie's ids must follow."""
        self.trie.remap(moves)


def _payload_nbytes(payload) -> int:
    """Size of a slot-state payload (a ``paged_cache.PendingSnapshot``)
    for the byte budget."""
    return int(getattr(payload, "nbytes", 0))
