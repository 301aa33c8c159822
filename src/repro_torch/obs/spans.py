"""Span timelines: ring-buffered begin/end spans over the serving hot
path.

Counters/histograms (``obs.metrics``) answer *how much*; spans answer
*where the time went inside a step*. A :class:`SpanRecorder` keeps a
bounded ring of completed :class:`Span` records — begin/end pairs with
implicit parent links (the serving control plane is single-threaded per
replica, so an open-span stack gives correct nesting for free), plus
zero-duration *instant* marks for point events (a prefix hit, a COW
fork, a quarantine). Every record can carry a request ``uid`` and the
recorder's ``replica`` id, so one request's life can be followed across
an admission on replica 0, a chaos kill, and a replay on replica 1.

Timestamps are ``time.perf_counter()`` — NOT the engine's injected
``clock`` (the chaos harness's stalled clock must see exactly its two
reads per step; spans never touch it). All recorders in one process
share the perf_counter epoch, which is what lets ``obs.export`` merge
multi-replica timelines onto one axis.

Disabled recorders (``SpanRecorder(enabled=False)``, or the shared
module-level :data:`NOOP`) make every call a cheap early return — the
``span()`` context manager hands back one shared singleton, no
allocation per call.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Span", "SpanRecorder", "NOOP"]


@dataclass
class Span:
    """One completed span (``kind='span'``) or point event
    (``kind='instant'``, where ``t1 == t0``)."""
    name: str
    t0: float
    t1: float
    sid: int                          # process-unique span id
    parent: Optional[int]             # sid of the enclosing open span
    uid: Optional[int] = None         # request uid, when one is in scope
    replica: Optional[int] = None     # recorder's replica id
    kind: str = "span"
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _Token:
    """Mutable handle for an open span; ``tok.args[...] = v`` annotates
    the span before it closes."""
    __slots__ = ("name", "t0", "sid", "parent", "uid", "args")

    def __init__(self, name, t0, sid, parent, uid, args):
        self.name = name
        self.t0 = t0
        self.sid = sid
        self.parent = parent
        self.uid = uid
        self.args = args


# Shared token handed out by disabled recorders. Its args dict is shared
# and never read — instrumentation sites may write a bounded set of keys
# into it without allocating anything per call.
_NOOP_TOKEN = _Token("", 0.0, 0, None, None, {})


class _SpanCtx:
    __slots__ = ("_rec", "tok")

    def __init__(self, rec, tok):
        self._rec = rec
        self.tok = tok

    def __enter__(self):
        return self.tok

    def __exit__(self, *exc):
        self._rec.end(self.tok)
        return False


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return _NOOP_TOKEN

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()

_SIDS = itertools.count(1)   # process-unique so merged exports never collide


class SpanRecorder:
    """Bounded ring of completed spans for one replica's control plane.

    Single-threaded by design (one recorder per replica, used from that
    replica's step loop); the open-span stack provides parent links.
    """

    def __init__(self, enabled: bool = True, maxlen: int = 65536,
                 replica: Optional[int] = None, clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.replica = replica
        self._clock = clock
        self._ring: deque = deque(maxlen=maxlen)
        self._stack: List[_Token] = []
        self.n_recorded = 0          # total ever; drops = n_recorded - len()

    # -- recording -----------------------------------------------------------

    def begin(self, name: str, uid: Optional[int] = None, **args) -> _Token:
        if not self.enabled:
            return _NOOP_TOKEN
        tok = _Token(name, self._clock(), next(_SIDS),
                     self._stack[-1].sid if self._stack else None,
                     uid, dict(args) if args else {})
        self._stack.append(tok)
        return tok

    def end(self, tok: _Token) -> None:
        if not self.enabled or tok is _NOOP_TOKEN:
            return
        t1 = self._clock()
        if self._stack and self._stack[-1] is tok:
            self._stack.pop()
        else:                        # tolerate out-of-order ends
            try:
                self._stack.remove(tok)
            except ValueError:
                pass
        self._append(Span(tok.name, tok.t0, t1, tok.sid, tok.parent,
                          uid=tok.uid, replica=self.replica, kind="span",
                          args=tok.args))

    def span(self, name: str, uid: Optional[int] = None, **args):
        """Context manager; yields the token (annotate via ``tok.args``)."""
        if not self.enabled:
            return _NOOP_CTX
        return _SpanCtx(self, self.begin(name, uid=uid, **args))

    def instant(self, name: str, uid: Optional[int] = None, **args) -> None:
        if not self.enabled:
            return
        t = self._clock()
        self._append(Span(name, t, t, next(_SIDS),
                          self._stack[-1].sid if self._stack else None,
                          uid=uid, replica=self.replica, kind="instant",
                          args=dict(args) if args else {}))

    def complete(self, name: str, t0: float, t1: float,
                 uid: Optional[int] = None, parent: Optional[int] = None,
                 **args) -> Optional[int]:
        """Record a span retroactively from explicit timestamps (used
        when the decision to record is only known after the fact, and by
        golden tests that need deterministic times). Returns the sid."""
        if not self.enabled:
            return None
        sid = next(_SIDS)
        self._append(Span(name, float(t0), float(t1), sid, parent,
                          uid=uid, replica=self.replica, kind="span",
                          args=dict(args) if args else {}))
        return sid

    def _append(self, rec: Span) -> None:
        self._ring.append(rec)
        self.n_recorded += 1

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> List[Span]:
        """Completed records, oldest first (open spans are not included)."""
        return list(self._ring)

    @property
    def dropped(self) -> int:
        return self.n_recorded - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._stack.clear()


#: Shared disabled recorder — the default for every instrumented class,
#: so un-armed deployments pay one ``if not self.enabled`` per call site.
NOOP = SpanRecorder(enabled=False, maxlen=1)
