"""Collectives over per-shard values, and the compressed cross-pod
gradient mean. Port of ``repro.distributed.collectives``.

The port drives every position of a mesh from one process
(``launch.mesh``), so a value sharded over an axis is a list: one tensor
a position, on that position's device. A sharded step runs its
shard-local phases once a position (:func:`axis_shard_map`) and meets at
the collectives below, which reduce the per-shard parts on the axis's
home device (its first position's); the replicated rest of the step runs
there, once, and :func:`broadcast` hands a replicated value back to the
positions (a no-op on the home device, a copy elsewhere). Reductions
run in shard order, so a result does not depend on where the shards
live:

    stitch_heads   concatenation of the head blocks in shard order
    pmax           elementwise max over the shards
    pmean          sum in shard order, divided by the axis size

``torch.distributed`` is not the backend: NCCL refuses two ranks on one
device, so on one card a process group could only run at TP = 1, and
the reference's host logic (engine, scheduler, router) is one
controller, not one a rank.

``compressed_pod_mean`` replaces the cross-pod gradient mean with the
paper's structured sketch (``optim.compression``):

    y   = sketch(grad + err)        m/n of the bytes, per pod
    y'  = pmean(y, 'pod')           the ONLY cross-pod traffic
    g'  = unsketch(y')              err absorbs the residual
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.obs import cost as _cost
from repro_torch.optim import compression as C


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a sharded step sees it: its name and the device
    of each position (the counterpart of the axis name a reference
    ``shard_map`` body passes to its collectives)."""
    name: str
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def axis_of(mesh, name: str) -> Axis:
    return Axis(name, tuple(mesh.axis_devices(name)))


@dataclass
class ShardedTree:
    """A tree laid out on a mesh axis: ``parts[i]`` is the plain tree
    position i holds (its own contiguous block of every sharded leaf,
    the replicated leaves whole), ``specs`` the spec tree it was laid
    out by (``distributed.sharding.P`` leaves)."""
    parts: List
    specs: object
    axis: Axis

    @property
    def tp(self) -> int:
        return self.axis.size


def broadcast(x, axis: Axis) -> List:
    """A replicated value (a tensor, or a tree of them) at every position
    of ``axis``: the same object where the device is the home's."""
    return [tree_lib.map(lambda t: t.to(dev), x) for dev in axis.devices]


def axis_shard_map(f: Callable, axis: Axis) -> Callable:
    """``f`` once a position of ``axis``: the returned function takes
    per-position lists and returns the list of ``f``'s results (the
    shard-local phase of a ``shard_map`` body; collectives run between
    such phases)."""
    def run(*parts: Sequence):
        if any(len(p) != axis.size for p in parts):
            raise ValueError(f"per-shard arguments of {axis.size} positions "
                             f"expected")
        return [f(*args) for args in zip(*parts)]
    return run


def _record(kind: str, t: torch.Tensor) -> None:
    """Under a cost analysis: one ``kind`` collective of ``t``'s bytes a
    device (an all-reduce counts x2 there)."""
    a = _cost.current()
    if a is not None:
        a.collective(kind, t.numel() * t.element_size())


def stitch_heads(parts: Sequence[torch.Tensor], axis: Axis,
                 head_dim: int = 1) -> torch.Tensor:
    """Concatenate per-shard head blocks into the full head axis, in
    shard order (== global head order under the column-parallel q/k/v
    split), on the home device. The mesh step stitches instead of
    summing a row-parallel wo: the replicated wo then contracts whole
    heads in the single-device order, so greedy tokens equal the
    unsharded engine's (a sum across shards re-associates d_model)."""
    out = torch.cat([p.to(axis.home) for p in parts], dim=head_dim)
    _record("all-gather", out)
    return out


def pmax(parts: Sequence[torch.Tensor], axis: Axis) -> torch.Tensor:
    """Elementwise max over the shards, on the home device."""
    _record("all-reduce", parts[0])
    return functools.reduce(torch.maximum, [p.to(axis.home) for p in parts])


def pmean(parts: Sequence[torch.Tensor], axis: Axis) -> torch.Tensor:
    """Mean over the shards: the sum in shard order over the axis size,
    on the home device."""
    _record("all-reduce", parts[0])
    total = parts[0].to(axis.home)
    for p in parts[1:]:
        total = total + p.to(axis.home)
    return total / len(parts)


def _per_pod(tree, axis: Axis) -> List:
    """Per-position trees: a list is one tree a pod; a tree alone is
    replicated (every pod holds it, the reference's ``P()`` in_spec)."""
    if isinstance(tree, list) and len(tree) == axis.size and \
            isinstance(tree[0], dict):
        return tree
    return [tree] * axis.size


def pod_mean_plain(grads, mesh) -> Dict:
    """Baseline: the uncompressed cross-pod mean of per-pod gradient
    trees (a list, one a pod), or of one replicated tree."""
    axis = axis_of(mesh, "pod")
    per = _per_pod(grads, axis)
    return tree_lib.map(lambda *xs: pmean(xs, axis), *per)


def compressed_pod_mean(grads, err, mesh, cc: C.CompressionConfig,
                        step: int = 0) -> Tuple[Dict, object]:
    """-> (mean gradients reconstructed, new error). ``grads`` and
    ``err`` are per-pod lists of trees (one a position of the mesh's
    ``pod`` axis) or single trees, replicated over the pods (the
    reference's trainer passes its replicated gradients so); the new
    error comes back in the same form. ``step`` rotates the sketch, so
    its null space is redrawn every step. The mean gradients come back
    in the gradients' dtypes, on the pod axis's home device."""
    axis = axis_of(mesh, "pod")
    replicated = not (isinstance(grads, list) and len(grads) == axis.size)
    gs, es = _per_pod(grads, axis), _per_pod(err, axis)
    done: Dict[Tuple[int, int], tuple] = {}
    sks, new_errs = [], []
    for g, e in zip(gs, es):
        key = (id(g), id(e))               # a replicated pod's work is one
        if key not in done:
            sk, _, ne = C.roundtrip_with_feedback(g, e, cc, step)
            done[key] = (sk, ne)
        sks.append(done[key][0])
        new_errs.append(done[key][1])
    sk_mean = tree_lib.map(lambda *ys: pmean(ys, axis), *sks)
    g_mean = C.decompress_tree(sk_mean, gs[0], cc, step)
    g_mean = tree_lib.map(lambda a, b: a.to(b.dtype), g_mean, gs[0])
    return g_mean, (new_errs[0] if replicated else new_errs)
