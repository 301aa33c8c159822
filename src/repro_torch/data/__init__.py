"""Deterministic synthetic data and the sharded prefetching loader (port
of ``repro.data``)."""
