"""Elastic scaling: reshard a training state onto a grown or shrunk mesh.
Port of ``repro.ft.elastic``.

Checkpoints store logically global tensors, so elasticity is a
*placement* change: rebuild the mesh with the surviving devices,
recompute the specs from the same logical rules, and place. Data streams
re-split by the new shard count (the synthetic streams are functions of
the shard id, so this is exact). The only constraint is divisibility,
checked here with a fallback to replication.

A placed tensor is :class:`Placed`: one contiguous block a mesh position
(the port's one-process mesh, ``launch.mesh``), on that position's
device; a replicated dim repeats the whole extent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import Mesh


def viable_data_axis(n_devices: int, model: int) -> int:
    if n_devices % model:
        raise ValueError(f"{n_devices} devices not divisible by model={model}")
    return n_devices // model


def remesh(devices, model_parallel: int, axis_names=("data", "model")) -> Mesh:
    """Build the largest (data, model) mesh from surviving devices."""
    n = len(devices)
    data = viable_data_axis(n, model_parallel)
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr[: data * model_parallel].reshape(data, model_parallel),
                axis_names)


def _degrade(spec: P, shape, mesh) -> P:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for dim, names in enumerate(tuple(spec)
                                + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        total = 1
        for nme in names_t:
            total *= sizes.get(nme, 1)
        out.append(names if shape[dim] % total == 0 else None)
    return P(*out)


@dataclass
class Placed:
    """A tensor laid out on a mesh: ``blocks[idx]`` is the block of mesh
    position ``idx`` (a numpy index over ``mesh.devices``), on its
    device. Blocks of positions that hold the same slice on the same
    device are one tensor."""
    spec: P
    shape: Tuple[int, ...]
    mesh: Mesh
    blocks: Dict[Tuple[int, ...], torch.Tensor]

    def gather(self) -> torch.Tensor:
        """The global tensor, on the CPU."""
        out = torch.empty(self.shape, dtype=next(iter(
            self.blocks.values())).dtype)
        for idx, blk in self.blocks.items():
            out[_block_index(self.spec, self.shape, self.mesh, idx)] = \
                blk.cpu()
        return out


def _block_index(spec: P, shape, mesh, idx) -> Tuple[slice, ...]:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    pos = dict(zip(mesh.axis_names, idx))
    sl = []
    for dim, names in enumerate(tuple(spec)
                                + (None,) * (len(shape) - len(spec))):
        if names is None:
            sl.append(slice(None))
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        k, n = 0, 1
        for nme in names_t:                    # row-major over the names
            k = k * sizes.get(nme, 1) + pos.get(nme, 0)
            n *= sizes.get(nme, 1)
        w = shape[dim] // n
        sl.append(slice(k * w, (k + 1) * w))
    return tuple(sl)


def place(x, spec: P, mesh) -> Placed:
    """One contiguous block of ``x`` a mesh position, on its device."""
    x = torch.as_tensor(x)
    spec = _degrade(spec, tuple(x.shape), mesh)
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
    made: Dict[Tuple, torch.Tensor] = {}
    for idx in np.ndindex(mesh.devices.shape):
        sl = _block_index(spec, tuple(x.shape), mesh, idx)
        dev = mesh.devices[idx]
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if key not in made:
            made[key] = x[sl].to(dev, copy=True).contiguous()
        blocks[idx] = made[key]
    return Placed(spec, tuple(x.shape), mesh, blocks)


def reshard_tree(tree, specs, mesh):
    """Place a (host-global) tree onto ``mesh`` per the spec tree,
    degrading any axis that no longer divides to replication."""
    return tree_lib.map(lambda x, s: place(x, s, mesh), tree, specs)


def shrink_plan(old_hosts: int, failed: Tuple[int, ...], model: int
                ) -> Dict[str, int]:
    """Controller-side plan after host failures: new data-axis width and
    the data-shard remapping (streams are functions of shard id)."""
    alive: List[int] = [h for h in range(old_hosts) if h not in failed]
    return {"alive_hosts": len(alive), "new_data_axis": len(alive),
            "shard_of_host": {h: i for i, h in enumerate(alive)}}
