"""Counted cost of one eager call: flops, HBM bytes, collective bytes and
the peak of live bytes. The port's counterpart of
``repro.launch.hlo_analysis``.

The reference walks the compiled, partitioned HLO of a step. The port
has no HLO: it runs a step once, eagerly, on any device (``meta``
included: shapes and dtypes, no storage, no arithmetic) under two
dispatch modes and counts what the step dispatches:

  flops             ``torch.utils.flop_counter.FlopCounterMode``: 2*M*N*K
                    a matrix product (mm, bmm, addmm, convolution, and
                    what einsum and matmul lower to); elementwise flops
                    are ignored, as in the reference's model.
  bytes             each aten operator's tensor operands and outputs
                    (a tensor's bytes at most its storage's: an expanded
                    view reads what it holds). Operators whose outputs
                    alias an input (views) move none; an in-place
                    operator reads its other operands and writes as many
                    bytes (all of its target when it has none: a fill).
  peak_bytes        live bytes: an output's storage is added when it is
                    created and subtracted when its last tensor is freed
                    (``weakref.finalize``); the most at once. Tensors
                    that existed before the call (params, inputs) are
                    not counted; ``arg_bytes`` gives theirs.
  collective_bytes  from ``distributed.collectives`` (``stitch_heads`` an
                    all-gather of its output's bytes; ``pmax`` and
                    ``pmean`` all-reduces of a part's bytes, counted x2
                    as the reference counts an all-reduce), per kind in
                    ``coll/<kind>``.

The custom kernels: every dispatcher of ``kernels/ops.py`` adds its
kernel's operations (to ``flops``) and bytes by the formulas of
``kernels/cost.py``, the ones ``PERF.md`` and ``chip_smoke.py`` bound a
kernel by, and runs the kernel (or, off the card, its plain version)
with these modes off, so none of its work is counted twice; on ``meta``
it returns an empty output of the kernel's shape.

Approximations: eager code moves unfused bytes (every intermediate
goes to memory and back, where XLA fuses elementwise chains), so
``bytes`` is larger than the reference's fused count; the peak follows
eager allocation order, not a compiler's schedule. Roofline terms are
over an NVIDIA H100 SXM5's datasheet peaks, not measurements.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs import cost as _hooks

# NVIDIA H100 SXM5 80GB (700 W) datasheet values, not measurements
PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
HBM_BW = 3.35e12           # B/s, HBM3
LINK_BW = 450e9            # B/s, NVLink 4, one direction

_ALLOCATE_ONLY = {torch.ops.aten.empty.memory_format,
                  torch.ops.aten.empty_strided.default,
                  torch.ops.aten.empty_like.default}


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor holds: numel x itemsize, at most its storage's
    (an expanded or broadcast view holds only its storage)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (an operator's
    arguments, a step's arguments, a kernel's outputs)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def unique_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class _ByteMode(TorchDispatchMode):
    def __init__(self, analysis: "Analysis"):
        super().__init__()
        self.analysis = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        a = self.analysis
        outs = _tensors(out)
        if func in _ALLOCATE_ONLY:
            for t in outs:
                a._allocate(t)
            return out
        rets = func._schema.returns
        alias = [r.alias_info for r in rets if r.alias_info is not None]
        ins = _tensors((args, kwargs))
        if alias and not any(x.is_write for x in alias):        # a view
            for t in outs:
                a._share(t)
            return out
        if alias:                                               # in place
            targets = [arg for arg, s in zip(args, func._schema.arguments)
                       if s.alias_info is not None and s.alias_info.is_write
                       and isinstance(arg, torch.Tensor)]
            keys = {_key(t) for t in targets}
            rest = sum(tensor_bytes(t) for t in ins if _key(t) not in keys)
            written = sum(tensor_bytes(t) for t in targets)
            a.bytes += rest + (min(written, rest) if rest else written)
            return out
        a.bytes += sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
        for t in outs:
            a._allocate(t)
        return out


class Analysis:
    """One counted call: ``with Analysis() as a: fn(...)``, then
    :meth:`result`. Nested analyses count in the innermost only."""

    def __init__(self):
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.coll: Dict[str, float] = defaultdict(float)
        self.coll_count = 0
        self.shares: List[tuple] = []
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, List[int]] = {}      # storage -> [refs, bytes]
        self._stack: Optional[contextlib.ExitStack] = None
        self._flops: Optional[FlopCounterMode] = None

    # --- lifetime -----------------------------------------------------------

    def __enter__(self) -> "Analysis":
        self._stack = contextlib.ExitStack()
        self._flops = self._stack.enter_context(FlopCounterMode(display=False))
        self._stack.enter_context(_ByteMode(self))
        _hooks.push(self)
        self._stack.callback(_hooks.pop, self)
        return self

    def __exit__(self, *exc) -> bool:
        return bool(self._stack.__exit__(*exc))

    # --- live bytes ---------------------------------------------------------

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _allocate(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._refs:
            self._share(t)
            return
        nbytes = t.untyped_storage().nbytes()
        self._refs[key] = [1, nbytes]
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key)

    def _share(self, t: torch.Tensor) -> None:
        """Another tensor of a storage the analysis tracks (a view)."""
        key = _key(t)
        if key in self._refs:
            self._refs[key][0] += 1
            weakref.finalize(t, self._release, key)

    # --- hooks of obs.cost --------------------------------------------------

    def kernel(self, name: str, ops: float, nbytes: float,
               run: Callable[[], object], empty: Callable[[], object],
               inputs: Iterable[torch.Tensor] = ()):
        """A custom kernel's dispatch: its operations and bytes by
        formula; then ``empty()`` on meta, else ``run()`` with the modes
        off. New output storages count as live."""
        self.kernel_flops += ops
        self.bytes += nbytes
        self.kernel_calls[name] += 1
        ins = list(inputs)
        on_meta = any(t.is_meta for t in ins)
        with _disable_current_modes():
            out = empty() if on_meta else run()
        known = {_key(t) for t in ins}
        for t in _tensors(out):
            if _key(t) not in known:
                self._allocate(t)
        return out

    def collective(self, kind: str, nbytes: float) -> None:
        factor = 2.0 if kind == "all-reduce" else 1.0
        self.coll[kind] += factor * nbytes
        self.coll_count += 1

    def share(self, role: str, shape, width: int) -> None:
        """A constrained activation: its role, global shape and the
        number of devices it is split over."""
        self.shares.append((role, tuple(shape), int(width)))

    # --- result -------------------------------------------------------------

    def result(self) -> Dict[str, float]:
        out = {"flops": float(self._flops.get_total_flops())
               + self.kernel_flops,
               "bytes": float(self.bytes),
               "collective_bytes": float(sum(self.coll.values())),
               "collective_count": float(self.coll_count),
               "peak_bytes": float(self.peak),
               "kernel_flops": float(self.kernel_flops)}
        for k, v in self.coll.items():
            out[f"coll/{k}"] = v
        for k, v in self.kernel_calls.items():
            out[f"kernel/{k}"] = float(v)
        return out


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """``fn(*args, **kwargs)`` once under an :class:`Analysis`: its
    result, and ``arg_bytes`` (the arguments' distinct storages)."""
    with Analysis() as a:
        fn(*args, **kwargs)
    out = a.result()
    out["arg_bytes"] = float(unique_bytes((args, kwargs)))
    return out


def roofline_terms(per_device: Dict[str, float]) -> Dict[str, float]:
    """Wall-seconds terms of per-device counts over the datasheet peaks:
    compute, memory, collective; the largest bounds the step."""
    t_comp = per_device["flops"] / PEAK_FLOPS
    t_mem = per_device["bytes"] / HBM_BW
    t_coll = per_device["collective_bytes"] / LINK_BW
    dom = max(("compute", t_comp), ("memory", t_mem),
              ("collective", t_coll), key=lambda kv: kv[1])
    return {"t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
            "t_roofline": dom[1], "bottleneck": dom[0]}
