"""Logical sharding rules: param / optimizer / batch / cache specs.
Port of ``repro.distributed.sharding``.

Axis roles (``launch/mesh.py``):
    pod    slow-link data parallelism: compressed collectives
    data   data parallelism + ZeRO-1 shards + long-context seq sharding
    model  tensor parallelism (heads / ff / vocab / experts)

Rules are path and shape based and DEGRADE to replication whenever a dim
does not divide the axis (hymba's 25 heads, qwen2-vl's 12 heads under
TP = 16): the framework never refuses an arch for divisibility.

A spec (:class:`P`) is the counterpart of ``PartitionSpec``: one entry a
dim, an axis name, a tuple of names or None. Paths are the port's tree
paths ("segments/0/attn/wq"), the reference's ``_path_str``. A mesh is
anything with ``axis_names`` and ``devices.shape`` (``launch.mesh.Mesh``).
The activation constrainer (``make_constrainer``) and ``named`` feed the
dry run (``launch.dryrun``): the port has no partitioner, so a
constrained activation is returned unchanged and its per-device share
recorded to the active cost analysis, and ``named`` gives the shard
shapes the dry run counts per-device bytes by.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

from repro_torch import tree as tree_lib
from repro_torch.obs import cost as _cost


class P:
    """A partition spec: ``P(None, "model")`` shards dim 1 over the
    ``model`` axis. A tree leaf (not a tuple, so the port's tree helpers
    never descend into it); ``tuple(spec)`` gives the entries, with a
    tuple of one name given as the name and an empty one as None, as
    ``PartitionSpec`` normalizes them."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self.entries)) + ")"


def axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _fits(shape, dim: int, mesh, names) -> bool:
    if dim >= len(shape):
        return False
    total = 1
    for n in (names if isinstance(names, tuple) else (names,)):
        total *= axis_size(mesh, n)
    return shape[dim] % total == 0 and shape[dim] >= total


def _path_str(path) -> str:
    """The port's tree paths are strings already ("segments/0/attn/wq")."""
    return path if isinstance(path, str) else "/".join(map(str, path))


def _shape(x) -> Tuple[int, ...]:
    """A leaf's shape: tensors and shape structs, and () for a host
    scalar (the serve cache's "idx" and "pos")."""
    return tuple(getattr(x, "shape", ()))


# --- parameter rules --------------------------------------------------------

def _trailing_rule(path: str, shape, mesh) -> P:
    """(regex on path, spec builder on the TRAILING dims). Stacked layer
    params get a leading None prepended by :func:`param_specs`."""
    mdl = "model"

    def col():                              # column parallel (d, out)
        return _mk(shape, {1: mdl}, mesh)

    def row():                              # row parallel (in, d)
        return _mk(shape, {0: mdl}, mesh)

    if re.search(r"embed/tok$", path):
        return _mk(shape, {0: mdl}, mesh)                    # (V, d)
    if re.search(r"(^|/)head$", path):
        return _mk(shape, {1: mdl}, mesh)                    # (d, V)
    if re.search(r"moe/router$", path):
        return P(*([None] * len(shape)))                     # tiny
    if re.search(r"moe/(wi|wg)$", path):
        return _mk(shape, {0: mdl}, mesh)                    # (E, d, ffe) EP
    if re.search(r"moe/wo$", path):
        return _mk(shape, {0: mdl}, mesh)                    # (E, ffe, d) EP
    if re.search(r"(mlp|shared)/(wi|wg)$", path):
        return col()                                         # (d, ff)
    if re.search(r"(mlp|shared)/wo$", path):
        return row()                                         # (ff, d)
    if re.search(r"(attn|cross)/(wq|wuk|wuv)$", path):
        return col()
    if re.search(r"(attn|cross)/(wk|wv)$", path):
        return col()
    if re.search(r"(attn|cross)/wo$", path):
        return row()
    if re.search(r"attn/(wdkv|wkpe)$", path):
        return P(*([None] * len(shape)))                     # small latents
    if re.search(r"ssm/(wz|wx)$", path):
        return col()
    if re.search(r"ssm/(wbc|wdt)$", path):
        return P(*([None] * len(shape)))
    if re.search(r"ssm/conv_x$", path):
        return _mk(shape, {1: mdl}, mesh)                    # (k, di)
    if re.search(r"ssm/out_proj$", path):
        return row()
    if re.search(r"srf/", path):
        return P(*([None] * len(shape)))                     # O(n) generators
    if re.search(r"frontend/adapter$", path):
        return col()
    return P(*([None] * len(shape)))                         # norms, biases


def _mk(shape, placements: Dict[int, str], mesh) -> P:
    out = [None] * len(shape)
    for dim, name in placements.items():
        if _fits(shape, dim, mesh, name):
            out[dim] = name
    return P(*out)


_STACKED = re.compile(r"^(segments/\d+|encoder)/")


def param_specs(params, mesh) -> Dict:
    def f(path, x):
        ps = _path_str(path)
        shape = _shape(x)
        if _STACKED.match(ps):
            return P(None, *_trailing_rule(ps, shape[1:], mesh))
        return _trailing_rule(ps, shape, mesh)
    return tree_lib.map_with_path(f, params)


def zero1_specs(params, pspecs, mesh) -> Dict:
    """Optimizer-moment specs: param spec + shard the first free dim over
    'data' (ZeRO-1). Falls back to the param spec if nothing divides."""
    data = axis_size(mesh, "data")

    def f(x, spec):
        if data <= 1:
            return spec
        shape = _shape(x)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for dim in range(len(shape)):
            if entries[dim] is None and shape[dim] % data == 0 \
                    and shape[dim] >= 4 * data:
                entries[dim] = "data"
                return P(*entries)
        return spec
    return tree_lib.map(f, params, pspecs)


def opt_state_specs(opt_state, params, pspecs, mesh) -> Dict:
    z = zero1_specs(params, pspecs, mesh)
    return {"mu": z, "nu": z, "count": P()}


# --- batch / cache rules ------------------------------------------------------

def batch_specs_tree(batch_specs, mesh) -> Dict:
    """Shard dim0 (global batch) over the dp axes when it divides."""
    dp = dp_axes(mesh)

    def f(shape):
        if _fits(shape, 0, mesh, dp) and len(shape) >= 1:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    def g(path, s):
        shape = _shape(s)
        if _path_str(path).endswith("pos3"):   # (3, B, L): batch is dim1
            if _fits(shape, 1, mesh, dp):
                return P(None, dp, None)
            return P(None, None, None)
        return f(shape)
    return tree_lib.map_with_path(g, batch_specs)


def cache_specs_tree(cache_specs, cfg, mesh) -> Dict:
    """Decode caches: batch over dp; long axes (S for kv/mla, heads for
    srf and ssd state) over 'model' when they divide."""
    dp = dp_axes(mesh)

    def f(path, s):
        ps = _path_str(path)
        shape = _shape(s)
        stacked = 1 if ps.startswith("segments/") else 0   # leading layer dim
        ent = [None] * len(shape)
        if ps.endswith(("k", "v", "k_scale", "v_scale")) and \
                len(shape) - stacked == 4:
            # (L?, B, Hkv, S, hd|1): batch over dp, S over model
            if _fits(shape, stacked + 0, mesh, dp):
                ent[stacked + 0] = dp
            if _fits(shape, stacked + 2, mesh, "model"):
                ent[stacked + 2] = "model"
        elif ps.endswith(("s", "z")) and len(shape) - stacked >= 3:
            # SRF state (L?, B, H, m[, dv]): batch over dp, heads over model
            if _fits(shape, stacked + 0, mesh, dp):
                ent[stacked + 0] = dp
            if _fits(shape, stacked + 1, mesh, "model"):
                ent[stacked + 1] = "model"
        elif ps.endswith(("c", "kpe")) and len(shape) - stacked == 3:
            # MLA latent cache (L?, B, S, dim): batch over dp, S over model
            if _fits(shape, stacked + 0, mesh, dp):
                ent[stacked + 0] = dp
            if _fits(shape, stacked + 1, mesh, "model"):
                ent[stacked + 1] = "model"
        elif ps.endswith(("conv", "ssm")) and len(shape) - stacked >= 3:
            if _fits(shape, stacked + 0, mesh, dp):
                ent[stacked + 0] = dp
            if ps.endswith("ssm") and _fits(shape, stacked + 1, mesh,
                                            "model"):
                ent[stacked + 1] = "model"   # ssd heads
        elif ps.endswith("memory"):
            if _fits(shape, 0, mesh, dp):
                ent[0] = dp
        return P(*ent)
    return tree_lib.map_with_path(f, cache_specs)


# --- activation constrainer (models/hooks.py) ---------------------------------

def _width(mesh, entries) -> int:
    """Devices a spec's entries split a tensor over."""
    total = 1
    for e in entries:
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                total *= axis_size(mesh, name)
    return total


def make_constrainer(mesh, cfg=None):
    """``hooks.constrain``'s mesh-aware rules (the reference's): per role,
    the spec an activation would be laid out by. The port applies no
    layout: the tensor comes back unchanged, and under a cost analysis
    its global shape and the devices its spec splits it over are
    recorded (``Analysis.share``)."""
    dp = dp_axes(mesh)

    def spec(shape, role: str):
        nd = len(shape)
        if role == "activation" and nd >= 2:
            return [dp] + [None] * (nd - 1) if _fits(shape, 0, mesh, dp) \
                else None
        if role == "residual" and nd == 3:
            # Megatron sequence parallelism: (B, T, d) -> (dp, 'model', -)
            ent = [None, None, None]
            if _fits(shape, 0, mesh, dp):
                ent[0] = dp
            if _fits(shape, 1, mesh, "model"):
                ent[1] = "model"
            return spec(shape, "activation") if ent[1] is None else ent
        if role == "logits" and nd == 3:
            ent = [None, None, None]
            if _fits(shape, 0, mesh, dp):
                ent[0] = dp
            if _fits(shape, 2, mesh, "model"):
                ent[2] = "model"
            return ent
        if role == "moe_buf" and nd == 4:
            # (B groups, E, C, d): groups on dp, experts on model (EP)
            ent = [None, None, None, None]
            if _fits(shape, 0, mesh, dp):
                ent[0] = dp
            if _fits(shape, 1, mesh, "model"):
                ent[1] = "model"
            return ent
        return None

    def fn(x, role: str):
        a = _cost.current()
        if a is not None:
            ent = spec(tuple(x.shape), role)
            if ent is not None:
                a.share(role, x.shape, _width(mesh, ent))
        return x
    return fn


class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    :meth:`shard_shape` is the block one device holds."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        for dim, e in enumerate(self.spec):
            if e is not None:
                w = _width(self.mesh, [e])
                if out[dim] % w:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                     f"divide over {e!r} ({w})")
                out[dim] //= w
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named(mesh, tree_specs):
    """A spec tree's :class:`NamedSharding` s."""
    return tree_lib.map(lambda s: NamedSharding(mesh, s), tree_specs)
