"""Atomic, integrity-checked, async checkpoints (port of
``repro.checkpoint``)."""
