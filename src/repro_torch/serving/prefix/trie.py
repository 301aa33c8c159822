"""Page-granularity radix trie over token ids.

Each node covers EXACTLY ONE page of the paged KV pool: its ``key`` is
the tuple of tokens cached in that page (up to ``page_size`` of them)
and its ``page`` is the pool page id holding their KV rows. Only
full-page nodes (``len(key) == page_size``) may have children; a node
whose key is shorter — the unaligned tail of some donor prompt — is
always a leaf. Because a prompt is inserted page by page, the classic
radix-tree edge-splitting never arises: two prompts diverging inside a
page simply produce two sibling partial leaves (each holding its own
page), and the shared part up to the last common FULL page is one path.

The trie stores ids, never device data: the engine owns the pools, the
allocator owns the refcounts (the cache holds ONE reference per node
page), and lookup returns page ids + the matched token count for the
scheduler to attach to a request's block table.

Namespaces partition the trie: decoder KV depends on the enc-dec
encoder memory, so token-equal prompts under different encoder inputs
must never share pages — the engine keys enc-dec requests by a hash of
the encoder features (``namespace 0`` otherwise).

Eviction is LRU over leaves (a monotonic touch counter stamps every
node on the lookup/insert path): evicting an interior node would orphan
its children's path, and a leaf whose page is still shared with a
running request (allocator refcount > 1) is pinned — dropping the cache
reference would free nothing and only destroy reuse while the donor is
live. Dropping a leaf may expose its parent as the next LRU candidate.

Port: a copy of ``repro.serving.prefix.trie`` (host Python; the
port keeps its own copy and imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

Key = Tuple[int, ...]


@dataclass(eq=False)                    # identity eq/hash: nodes are places
class TrieNode:
    """One cached page: ``key`` tokens -> pool page ``page``."""
    key: Key
    page: int
    parent: Optional["TrieNode"] = None
    children: Dict[Key, "TrieNode"] = field(default_factory=dict)
    stamp: int = 0                      # LRU touch tick
    payload: Optional[object] = None    # slot-state snapshot (hybrid/ssd)
    payload_tokens: int = 0             # prompt tokens the payload covers

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclass
class TrieMatch:
    """Result of one lookup walk (token counts, page ids — no pins)."""
    tokens: int                         # matched tokens (raw lcp)
    pages: List[int]                    # full shared pages, in order
    boundary_page: Optional[int]        # page holding the unaligned tail
    # (payload_tokens, payload) per fully-matched node carrying one,
    # shallowest first — the cache picks the deepest under its cap
    payloads: List[Tuple[int, object]] = field(default_factory=list)
    nodes: List[TrieNode] = field(default_factory=list)


def _lcp(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixTrie:
    """Token-id trie with one page per node; ids only, no device state."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._roots: Dict[int, TrieNode] = {}
        self._tick = 0
        self.n_nodes = 0

    # -- internals -----------------------------------------------------------

    def _touch(self, node: TrieNode) -> None:
        self._tick += 1
        node.stamp = self._tick

    def _best_child(self, node: TrieNode,
                    rest: Tuple[int, ...]) -> Tuple[Optional[TrieNode], int]:
        """Child with the longest key-prefix match against ``rest``.
        Exact full-page matches are a dict hit; otherwise every child key
        is scanned (children of one node are few in practice — siblings
        only exist where prompts actually diverge)."""
        P = self.page_size
        if len(rest) >= P:
            child = node.children.get(tuple(rest[:P]))
            if child is not None:
                return child, P
        best, best_n = None, 0
        for key, child in node.children.items():
            n = _lcp(key, rest)
            if n > best_n:
                best, best_n = child, n
        return best, best_n

    # -- walk ----------------------------------------------------------------

    def walk(self, ns: int, tokens, touch: bool = True) -> TrieMatch:
        """Longest-prefix walk of ``tokens`` (raw: no caller caps applied
        here). ``pages``/``boundary_page`` describe the raw match:
        ``tokens // page_size`` full pages plus the node holding any
        unaligned remainder. Payloads are only collected from nodes whose
        ENTIRE key matched — a partially matched tail node's state
        describes tokens the walker does not have."""
        root = self._roots.get(ns)
        toks = tuple(int(t) for t in tokens)
        m = TrieMatch(tokens=0, pages=[], boundary_page=None)
        if root is None:
            return m
        node, d = root, 0
        while True:
            child, n = self._best_child(node, toks[d:])
            if child is None or n == 0:
                break
            if touch:
                self._touch(child)
            m.nodes.append(child)
            d += n
            if n == len(child.key) and child.payload is not None:
                m.payloads.append((child.payload_tokens, child.payload))
            if n < len(child.key) or len(child.key) < self.page_size:
                # partial match, or a partial-key leaf: cannot descend
                m.boundary_page = child.page
                break
            node = child
        m.tokens = d
        # a trailing exactly-full node is a full page, not a boundary
        full = d // self.page_size
        m.pages = [nd.page for nd in m.nodes[:full]]
        if d % self.page_size and m.boundary_page is None:
            m.boundary_page = m.nodes[full].page
        return m

    # -- insert --------------------------------------------------------------

    def insert(self, ns: int, tokens, pages: List[int]) -> Tuple[
            List[int], TrieNode]:
        """Record a fully prefilled prompt: page i of ``pages`` caches
        tokens ``[i*P, min((i+1)*P, len))``. Existing nodes on the path
        are reused (their pages stay canonical); NEW nodes take the
        donor's pages. Returns (newly referenced pages, final node) —
        the caller must ``share`` the new pages into the allocator and
        may attach a slot-state payload to the final node."""
        P = self.page_size
        toks = tuple(int(t) for t in tokens)
        if not toks:
            raise ValueError("cannot insert an empty prompt")
        if len(pages) != -(-len(toks) // P):
            raise ValueError(f"{len(pages)} pages cannot cover "
                             f"{len(toks)} tokens at page_size {P}")
        root = self._roots.setdefault(ns, TrieNode(key=(), page=0))
        node, new_pages = root, []
        for i in range(0, len(toks), P):
            key = toks[i:i + P]
            child = node.children.get(key)
            if child is None:
                child = TrieNode(key=key, page=pages[i // P], parent=node)
                node.children[key] = child
                new_pages.append(child.page)
                self.n_nodes += 1
            self._touch(child)
            node = child
        return new_pages, node

    # -- eviction ------------------------------------------------------------

    def _leaves_lru(self, skip=frozenset()) -> Iterator[TrieNode]:
        leaves = [nd for root in self._roots.values()
                  for nd in _iter_nodes(root) if nd.is_leaf
                  and nd not in skip]
        leaves.sort(key=lambda nd: nd.stamp)
        return iter(leaves)

    def remove(self, node: TrieNode) -> int:
        """Unlink a LEAF node; returns its page id (the caller drops the
        cache's allocator reference)."""
        if node.children:
            raise ValueError("evicting an interior node would orphan "
                             "its children")
        node.parent.children.pop(node.key)
        node.parent = None
        self.n_nodes -= 1
        return node.page

    def pages(self) -> List[int]:
        """Every page the cache currently references (one ref each)."""
        return [nd.page for root in self._roots.values()
                for nd in _iter_nodes(root)]

    def remap(self, moves: Dict[int, int]) -> None:
        """Apply a defrag move map {old: new} to every node's page id."""
        if not moves:
            return
        for root in self._roots.values():
            for nd in _iter_nodes(root):
                nd.page = moves.get(nd.page, nd.page)


def _iter_nodes(root: TrieNode) -> Iterator[TrieNode]:
    """All real nodes under (excluding) a namespace root."""
    stack = list(root.children.values())
    while stack:
        nd = stack.pop()
        yield nd
        stack.extend(nd.children.values())
