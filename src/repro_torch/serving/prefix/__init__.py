"""Prefix-sharing subsystem for the paged serving engine (port of
``repro.serving.prefix``).

* ``trie``  — page-granularity radix trie keyed on token ids
* ``cow``   — copy-on-write planning over the refcounted allocator
* ``chunk`` — budgeted chunked prefill interleaved with decode
* ``cache`` — the :class:`PrefixCache` facade + :class:`PrefixConfig`

Wiring: ``Engine(..., prefix=PrefixConfig())`` builds the cache on
engines whose plan has a paged domain (full-KV attention), and the
scheduler consults it at admission. Greedy outputs are identical to the
cold-cache path (``tests/test_torch_serving.py``).
"""
from .cache import PrefixCache, PrefixConfig          # noqa: F401
from .chunk import ChunkConfig, ChunkPolicy           # noqa: F401
from .cow import Fork, PrefixMatch                    # noqa: F401
from .trie import RadixTrie, TrieMatch, TrieNode      # noqa: F401
