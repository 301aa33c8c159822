"""Pool and parameter layout for mesh-sharded paged serving.
Port of ``repro.serving.mesh.shard``.

The *model* axis shards the head dim of the attention pools, and any
dim that does not divide the axis DEGRADES to replication: the framework
never refuses a config for divisibility. Page *tables* stay host-side
scheduler bookkeeping; only the pools are device state.

Per-family layout (leaf shapes carry a leading layer axis L):

=========  =========================================  ==================
family     pool leaf (global shape)                   model-axis dim
=========  =========================================  ==================
``kv``     k/v        (L, N, P, Hkv, hd)              3 (kv heads)
           k/v_scale  (L, N, P, 1)    [int8 pools]    replicated (tiny)
``srf``    s          (L, S, Hq, m, dv)               2 (q heads)
           z          (L, S, Hq, m)                   2 (q heads)
``mla``    c / kpe    (L, N, P, lora|rope)            replicated
``ssd``    conv / ssm (L, S, ...)                     replicated
``mem``    enc memory (S, enc_len, d_model)           replicated
=========  =========================================  ==================

A hybrid layer's kv sub-pool shards on Hkv while its ssd sub-pool
replicates; an enc-dec model shards its self-attention kv pages and
replicates the encoder-memory pool, with the cross-attention projections
column-sliced like the self-attention ones. ``paged_tp`` is the single
gate: the effective tensor-parallel width (1 = the plain, replicated
engine) from which every other helper derives.

The port's placement (one process drives the mesh, ``launch.mesh``):
:func:`place_pools` and :func:`place_params` return a
``collectives.ShardedTree``, one plain tree a position of the model
axis. A sharded leaf is one contiguous tensor a position, on its device
(never a strided view of a global tensor: the paged_gather kernel reads
a pool as (N, P·D) rows). A replicated parameter is one tensor per
distinct device. The replicated part of the step runs once, on the
home device (the first position's), so the replicated state it alone
touches (SSD slots, the enc-dec memory) lives there; the int8 scales,
which every shard's gather reads, are one tensor per distinct device,
each written by its shards with the same bytes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P


def paged_tp(cfg, mesh) -> int:
    """Effective model-axis TP width for paged serving: the mesh's
    ``model`` axis size when the plan's ATTENTION component shards (kv /
    srf with dividing head counts), else 1. Pure-SSM stacks and MLA
    latents always replicate."""
    if mesh is None:
        return 1
    tp = S.axis_size(mesh, "model")
    if tp <= 1:
        return 1
    from repro_torch.serving import paged_cache
    plan = paged_cache.plan_for(cfg)
    if plan.attn_family not in ("kv", "srf"):
        return 1
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        return 1
    if plan.attn_family == "srf":
        n_pm = cfg.n_heads if cfg.is_mla else cfg.n_kv_heads
        if n_pm % tp:                  # per-head P-model param stacks
            return 1
    return tp


# ---------------------------------------------------------------------------
# pool specs
# ---------------------------------------------------------------------------

def _pool_leaf_spec(fam: str, name: str, ndim: int, tp: int) -> P:
    ent = [None] * ndim
    if tp > 1:
        if fam == "kv" and name in ("k", "v") and ndim == 5:
            ent[3] = "model"                       # (L, N, P, Hkv, hd)
        elif fam == "srf" and name in ("s", "z") and ndim >= 4:
            ent[2] = "model"                       # (L, S, Hq, ...)
    return P(*ent)


def pool_specs(cfg, mesh, paged=None) -> Dict:
    """Spec tree matching ``paged_cache.init_pools``' container."""
    from repro_torch.serving import paged_cache
    plan = paged_cache.plan_for(cfg)
    tp = paged_tp(cfg, mesh)
    specs: Dict = {"paged": [], "slot": []}
    for _, _, comps in plan.segments:
        pseg: Dict = {}
        sseg: Dict = {}
        for comp, fam_name in comps:
            fam = paged_cache.FAMILIES[fam_name]
            one = fam.layer_pool(cfg, 2, 2, paged, device="meta")
            (sseg if fam.constant_state else pseg)[comp] = {
                k: _pool_leaf_spec(fam_name, k, v.dim() + 1, tp)
                for k, v in one.items()}
        specs["paged"].append(pseg or None)
        specs["slot"].append(sseg or None)
    if plan.has_memory:
        specs["memory"] = P()
    return specs


def _model_dim(spec: P) -> Optional[int]:
    for d, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return d
    return None


def _block(x: torch.Tensor, dim: int, i: int, tp: int, dev) -> torch.Tensor:
    """Position i's contiguous block of ``x`` along ``dim``, a fresh
    tensor on ``dev``."""
    w = x.shape[dim] // tp
    return x.narrow(dim, i * w, w).to(dev, copy=True).contiguous()


def place_pools(pools: Dict, cfg, mesh, paged=None):
    """Lay the pools of ``paged_cache.init_pools`` (any device, ``meta``
    included: only shapes and dtypes are read) out on the mesh, zeroed.
    -> the plain container on the home device when ``paged_tp`` is 1
    (the degraded layout), else a ``ShardedTree`` of per-position
    containers: the sharded leaves one zeroed block a position; the
    attention component's replicated leaves (the int8 scales) one
    tensor per distinct device; the other replicated leaves (SSD slots,
    the memory pool) one tensor on the home device."""
    axis = collectives.axis_of(mesh, "model")
    specs = pool_specs(cfg, mesh, paged)
    tp = paged_tp(cfg, mesh)

    def zeros(shape, a, dev):
        return torch.zeros(shape, dtype=a.dtype, device=dev)
    if tp <= 1:
        return tree_lib.map(lambda a: None if a is None
                            else zeros(a.shape, a, axis.home), pools)
    shared: Dict = {}

    def leaf(path, a, spec, i):
        if a is None:                  # a segment without this domain
            return None
        dev = axis.devices[i]
        d = _model_dim(spec)
        if d is not None:
            shape = list(a.shape)
            shape[d] //= tp
            return zeros(shape, a, dev)
        per_device = "/attn/" in path
        key = (path, str(dev) if per_device else "home")
        if key not in shared:
            shared[key] = zeros(a.shape, a, dev if per_device else axis.home)
        return shared[key]
    flat_specs = dict(tree_lib.leaves_with_path(specs))
    parts = [tree_lib.map_with_path(
        lambda path, a, i=i: leaf(path, a, flat_specs[path], i), pools)
        for i in range(tp)]
    return collectives.ShardedTree(parts, specs, axis)


# ---------------------------------------------------------------------------
# param specs (serving flavor: TP on attention only)
# ---------------------------------------------------------------------------

_STACKED = re.compile(r"^segments/\d+/")

# column parallel only: slice the output (head-block) dim of q/k/v (self
# and cross attention, and the MLA up-projections) so each shard
# computes its own heads. wo stays REPLICATED on purpose: the step
# stitches the per-shard head blocks (collectives.stitch_heads) and
# contracts the full wo, which reduces d_model in the single-device
# order, so greedy tokens equal the unsharded engine's. MLP / SSM /
# embed / head / norms and the whole enc-dec ENCODER stay replicated.
_COL = re.compile(r"(attn|cross)/(wq|wk|wv|wuk|wuv)$")
_BIAS = re.compile(r"attn/(bq|bk|bv)$")
_SRF = re.compile(r"attn/srf/")


def _serving_rule(path: str, shape, tp: int) -> P:
    ent = [None] * len(shape)
    if tp <= 1:
        return P(*ent)
    if _COL.search(path) and len(shape) == 2 and shape[1] % tp == 0:
        ent[1] = "model"
    elif _BIAS.search(path) and len(shape) == 1 and shape[0] % tp == 0:
        ent[0] = "model"
    elif _SRF.search(path) and len(shape) >= 1 and shape[0] % tp == 0:
        ent[0] = "model"               # per-kv-head P-model param stacks
    return P(*ent)


def serving_param_specs(params, cfg, mesh) -> Dict:
    """Param specs for the sharded paged step: attention projections
    sliced over 'model' (per-shard heads match the per-shard pool
    heads), everything else replicated. Fully replicated when
    ``paged_tp`` is 1. Leaves need only a ``shape``."""
    tp = paged_tp(cfg, mesh)

    def f(path, x):
        shape = tuple(x.shape)
        if path.startswith("encoder/") or path.startswith("enc_norm"):
            return P(*([None] * len(shape)))   # encoder runs outside
        if _STACKED.match(path):
            return P(None, *_serving_rule(path, shape[1:], tp))
        return _serving_rule(path, shape, tp)
    return tree_lib.map_with_path(f, params)


def place_params(params, cfg, mesh):
    """Lay ``params`` out on the mesh: the tree itself on the home device
    when ``paged_tp`` is 1, else a ``ShardedTree`` whose sharded leaves
    are one contiguous block a position and whose replicated leaves are
    one tensor per distinct device (the caller's own tensor where it
    already lies there)."""
    axis = collectives.axis_of(mesh, "model")
    tp = paged_tp(cfg, mesh)
    if tp <= 1:
        return tree_lib.map(lambda a: a.to(axis.home), params)
    specs = serving_param_specs(params, cfg, mesh)
    rep: Dict = {}

    def leaf(a, spec, i):
        dev = axis.devices[i]
        d = _model_dim(spec)
        if d is not None:
            return _block(a, d, i, tp, dev)
        key = (id(a), str(dev))
        if key not in rep:
            rep[key] = a.to(dev)
        return rep[key]
    parts = [tree_lib.map(lambda a, s, i=i: leaf(a, s, i), params, specs)
             for i in range(tp)]
    return collectives.ShardedTree(parts, specs, axis)


def local_cfg(cfg, tp: int):
    """The per-shard view of the model config: head counts divided by
    the TP width (q_dim / kv_dim are derived, so the sliced wq / wk / wv
    and cross-attention shapes line up; SSM dims derive from d_model and
    stay whole)."""
    if tp <= 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def global_shape(shape, spec: P, tp: int):
    """The global shape of a leaf whose position blocks are ``shape``."""
    d = _model_dim(spec)
    out = list(shape)
    if d is not None:
        out[d] *= tp
    return tuple(out)


def global_rows(parts: List[torch.Tensor], spec: P) -> torch.Tensor:
    """The per-position blocks of one leaf stitched back into the global
    tensor (shard order along the model dim; the first position's tensor
    for a replicated leaf)."""
    d = _model_dim(spec)
    if d is None:
        return parts[0]
    return torch.cat([p.to(parts[0].device) for p in parts], dim=d)


def split_rows(x: torch.Tensor, spec: P, tp: int) -> List[torch.Tensor]:
    """Inverse of :func:`global_rows`: position i's block of ``x`` (views;
    the whole of ``x`` for a replicated leaf)."""
    d = _model_dim(spec)
    if d is None:
        return [x] * tp
    return list(x.chunk(tp, dim=d))
