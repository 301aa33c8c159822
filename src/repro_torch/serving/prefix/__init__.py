"""Copy-on-write bookkeeping the scheduler shares with the prefix cache.

The prefix cache itself (radix trie, chunk policy) is not ported yet;
the scheduler only needs the ``Fork`` / ``PrefixMatch`` records here.
"""
from .cow import Fork, PrefixMatch                    # noqa: F401
