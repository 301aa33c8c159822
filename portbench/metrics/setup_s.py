"""Seconds from the start of the process to the window's opening:
imports, weights, the engine or the optimizer, kernel builds, warm-up
and the correctness steps that precede the window."""


def read(run):
    return run["setup_s"]
