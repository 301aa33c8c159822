"""Optimizer, learning-rate schedule and structured-JL gradient
compression (port of ``repro.optim``)."""
