"""Kernel profiling hooks for the dispatch sites of ``kernels/ops.py``.

Port of ``repro.obs.profiling``. Two layers:

* :func:`annotate` is ``torch.profiler.record_function``: a named range
  that shows in ``torch.profiler`` (Kineto) traces, the counterpart of
  the reference's ``jax.named_scope``. :func:`dispatch` opens one around
  a kernel dispatch while a profiler is recording or timing is on.
* **Opt-in per-dispatch timing**: after :func:`enable_kernel_timing`,
  every dispatch is timed to completion and recorded into the registry's
  ``kernel_dispatch_seconds{kernel=...}`` histogram. The port runs
  eagerly, so every dispatch the engine makes is timed (the reference's
  serving loop runs under ``jit``, where its timing records nothing).
  Forcing a sync per dispatch serializes the card's queue, so timing
  stays off unless asked for (``serving/README.md`` gives its cost).

With timing off and no profiler recording, :func:`dispatch` is
``fn()``: it changes no result, no launch count and no autograd graph.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

_timing_registry = None                    # None = timing off


def enable_kernel_timing(registry) -> None:
    """Route per-dispatch timings into ``registry`` (a
    ``MetricsRegistry``)."""
    global _timing_registry
    _timing_registry = registry


def disable_kernel_timing() -> None:
    global _timing_registry
    _timing_registry = None


def kernel_timing_enabled() -> bool:
    return _timing_registry is not None


def annotate(name: str):
    """A named profiler range for a kernel region (``with annotate(n):``)."""
    return torch.profiler.record_function(name)


def _untimeable() -> bool:
    """Where the reference skips tracers: a Python timer and a sync make
    no sense while ``torch.compile`` traces, and a sync is illegal while
    a CUDA graph captures."""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    return isinstance(out, (tuple, list)) and any(_on_cuda(t) for t in out)


def dispatch(name: str, fn: Callable[[], object],
             registry: Optional[object] = None):
    """Run one kernel dispatch ``fn()`` (a zero-argument closure, so the
    timer brackets the dispatch and not the caller's argument work).

    With timing on (``registry``, or the one of
    :func:`enable_kernel_timing`), the card is synchronized before the
    timer starts (unlike the reference, which has no such sync: queued
    work would otherwise be charged to this dispatch) and, when the
    result holds a CUDA tensor, again after ``fn()``; the wall time goes
    into ``kernel_dispatch_seconds{kernel=name}``. Timing is skipped
    under ``torch.compile`` tracing and CUDA-graph capture.
    """
    reg = registry if registry is not None else _timing_registry
    if reg is None or _untimeable():
        if torch.autograd.profiler._is_profiler_enabled:
            with annotate(name):
                return fn()
        return fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with annotate(name):
        out = fn()
    if _on_cuda(out):
        torch.cuda.synchronize()
    reg.histogram(
        "kernel_dispatch_seconds",
        "kernel dispatch wall time, synced before and after (opt-in, "
        "serializing)",
        ("kernel",),
    ).labels(kernel=name).observe(time.perf_counter() - t0)
    return out
