"""The active cost analysis, where the layers below the launcher report
what the aten operators cannot show (``launch/cost_analysis.py`` owns the
analysis itself):

* the dispatchers of ``kernels/ops.py`` add each kernel's operations
  and bytes by formula (``kernels/cost.py``) and run the kernel unseen;
* the collectives of ``distributed/collectives.py`` add their bytes;
* ``distributed.sharding.make_constrainer`` adds each constrained
  activation's per-device share.

With no analysis active, :func:`current` is None and every hook is one
test of it.
"""
from __future__ import annotations

from typing import List, Optional

_active: List[object] = []


def current() -> Optional[object]:
    """The innermost active analysis, or None."""
    return _active[-1] if _active else None


def push(analysis) -> None:
    _active.append(analysis)


def pop(analysis) -> None:
    if not _active or _active[-1] is not analysis:
        raise RuntimeError("cost analyses must end in the reverse order of "
                           "their start")
    _active.pop()
