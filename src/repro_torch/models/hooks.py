"""Sharding-constraint hook. Models call ``constrain(x, role)`` at a few
activation boundaries, as in ``repro.models.hooks``; the port runs on one
card, so it is the identity."""
from __future__ import annotations


def constrain(x, role: str):
    return x
