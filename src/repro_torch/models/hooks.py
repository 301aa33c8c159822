"""Sharding-constraint hook. Models call ``constrain(x, role)`` at a few
activation boundaries, as in ``repro.models.hooks``; a launcher may
install another implementation with ``set_constrainer`` (the dry run
installs ``distributed.sharding.make_constrainer``, which records each
constrained activation's per-device share) and restore the identity
default with ``reset``, so the models import mesh-free."""
from __future__ import annotations


def _identity(x, role: str):
    return x


_fn = _identity


def constrain(x, role: str):
    return _fn(x, role)


def set_constrainer(fn) -> None:
    global _fn
    _fn = fn


def reset() -> None:
    global _fn
    _fn = _identity
