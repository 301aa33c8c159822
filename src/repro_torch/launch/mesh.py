"""Meshes: named axes over devices. Port of ``repro.launch.mesh``.

A :class:`Mesh` is the counterpart of ``jax.sharding.Mesh``: an array of
``torch.device`` s with one name per axis. One process drives every
position of it (the reference runs one controller per host over that
host's chips: "each slice is one host's chips"), so a device may repeat:
a mesh of ``cuda:0`` repeated runs every sharded code path, and every
kernel at its per-shard shapes, on one card, as the reference's tests
build a mesh from one device repeated. Such a mesh saves no memory on
the card; a mesh over distinct cards spreads the shards.

Importing this module touches no device; ``make_production_mesh`` is a
function.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes (``devices.shape`` one size per
    name). ``devices`` is a numpy object array of ``torch.device`` s."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    def axis_devices(self, name: str) -> List[torch.device]:
        """The devices of the positions along ``name``, the other axes
        at their first position (one device for an axis the mesh lacks:
        the first)."""
        if name not in self.axis_names:
            return [self.devices.flat[0]]
        ax = self.axis_names.index(name)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out

    @property
    def home(self) -> torch.device:
        """The first position's device: where the replicated part of a
        sharded step runs."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({describe(self)}, devices={list(self.devices.flat)})"


def _take(devices, need: int, device=None) -> List[torch.device]:
    """``devices``, or the visible cards, or with ``device="cpu"``
    ``need`` CPU positions."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * need
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Single pod: (16, 16) ('data', 'model') = 256 devices. Multi-pod:
    (2, 16, 16) ('pod', 'data', 'model') = 512. Raises ``ValueError`` on
    a machine with fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_mesh(shape, axes, devices=None, device=None) -> Mesh:
    """Arbitrary mesh (tests, elastic reshapes) over ``devices`` (default:
    the visible cards, or CPU positions with ``device="cpu"``)."""
    need = int(np.prod(shape))
    devs = _take(devices, need, device)
    if len(devs) < need:
        raise ValueError(f"need {need} devices for mesh {tuple(shape)}, "
                         f"have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def make_serving_meshes(replicas: int, model_parallel: int = 1,
                        devices=None, device=None) -> List[Mesh]:
    """Partition the devices into per-replica ('data', 'model') meshes
    for the router: ``replicas`` engine replicas, each a
    ``model_parallel``-wide tensor-parallel slice (the data axis is 1:
    the router, not a batch axis, spreads requests over replicas).

    ``devices`` default: the visible cards, or with ``device="cpu"`` as
    many CPU positions as asked. Raises ``ValueError`` when the devices
    cannot cover ``replicas * model_parallel``; a mesh of one card
    repeated is built by passing ``devices`` explicitly."""
    need = replicas * model_parallel
    devs = _take(devices, need, device)
    if len(devs) < need:
        raise ValueError(f"need {need} devices for {replicas} replicas x "
                         f"model={model_parallel}, have {len(devs)}")
    out = []
    for i in range(replicas):
        arr = np.empty(model_parallel, dtype=object)
        arr[:] = devs[i * model_parallel:(i + 1) * model_parallel]
        out.append(Mesh(arr.reshape(1, model_parallel), ("data", "model")))
    return out


def describe(mesh: Mesh) -> str:
    return " x ".join(f"{n}={s}" for n, s in
                      zip(mesh.axis_names, mesh.devices.shape))
