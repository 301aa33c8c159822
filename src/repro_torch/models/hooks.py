"""Sharding-constraint hook. Models call ``constrain(x, role)`` at a few
activation boundaries, as in ``repro.models.hooks``; a launcher may
install another implementation with ``set_constrainer``. The default is
the identity, so the models import mesh-free (the reference's
mesh-aware constrainer, ``make_constrainer``, feeds its dry-run
lowering, which the port has not ported)."""
from __future__ import annotations


def _identity(x, role: str):
    return x


_fn = _identity


def constrain(x, role: str):
    return _fn(x, role)


def set_constrainer(fn) -> None:
    global _fn
    _fn = fn
