"""Pooled, pre-allocated decode caches for the paged engine.

Port of ``repro.serving.paged_cache``:

=========  ==============================================  ===============
family     page contents (per layer)                       state growth
=========  ==============================================  ===============
``kv``     k/v pages   (num_pages, P, Hkv, hd) x2          O(L) paged
           (int8 pages + (num_pages, P, 1) f32 scales x2
           with ``PagedConfig(quantize_kv=True)``)
``mla``    latent c    (num_pages, P, kv_lora)
           + rope kpe  (num_pages, P, qk_rope)             O(L) paged
``srf``    feature S   (num_slots, Hq, m, dv)
           + norm z    (num_slots, Hq, m)                  O(m d) constant
``ssd``    conv tail   (num_slots, k-1, d_inner + 2 ns)
           + state     (num_slots, nh, ns, hd) f32         O(1) constant
``mem``    encoder memory (num_slots, enc_len, d_model)    O(1), read-only
           (one pool of the model, enc-dec only)
=========  ==============================================  ===============

``kv`` and ``mla`` grow one page per ``page_size`` tokens in the
*paged* index domain (page ids from the scheduler's allocator); ``srf``
(the paper's constant-size state) and ``ssd`` (the SSM state) hold one
slot per request in the *slot* domain. A hybrid layer owns an attention
component and an ssd component: a kv sub-pool in the paged domain and
an ssd sub-pool in the slot domain (or, with SRF attention, two slot
sub-pools). Only ``kv`` quantizes: MLA latents are already compressed
and stay in the model's dtype under ``quantize_kv``. An enc-dec
request also holds one slot of the memory pool, written once at
admission by the encoder and read by every decoder step.

The pool container keeps the reference's layout::

    {"paged": [per-segment {"attn": {leaf: (L, num_pages, ...)}} | None],
     "slot":  [per-segment {"attn": {leaf: (L, num_slots, ...)}} | None],
     "memory": (num_slots, enc_len, d_model)}        # enc-dec only

Page 0 and slot 0 are reserved: padded batch rows, and the invalid rows
of a chunk, write there and no live request reads them. Unlike the
reference, whose arrays are immutable and returned anew, every pool here
is one preallocated tensor per leaf (every layer allocated on its own,
never a broadcast view) that the model step and the helpers below update
IN PLACE; the helpers return the same container for the reference's
call shape.

Mesh-sharded pools (``init_pools(..., mesh=)``, the layout of
``serving.mesh.shard``) are a ``distributed.collectives.ShardedTree``:
one container a position of the mesh's ``model`` axis. Every helper
takes either form: COW copies and zeroing reach every shard's block
(and each replicated tensor once), and a snapshot holds GLOBAL rows
(the head blocks stitched in shard order), so it restores on a replica
of another TP width. ``pool_bytes`` counts the global pools,
``pool_bytes_per_device`` what one mesh position holds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Protocol, Tuple

import torch

from repro_torch.distributed.collectives import ShardedTree
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as model_lib


@dataclass(frozen=True)
class PagedConfig:
    """Pool-layout knobs orthogonal to the scheduler's SchedConfig.

    ``quantize_kv``: store KV pages as int8 with one f32 scale per page
    row (per cached token); the dequant is fused into the
    paged_gather_dequant kernel. Only the ``kv`` family quantizes."""
    quantize_kv: bool = False


class CacheFamily(Protocol):
    """A cache family owns the pool layout of one serving state kind."""
    name: str
    constant_state: bool     # True: one fixed-size slot per request

    def layer_pool(self, cfg, num_pages: int, page_size: int,
                   paged: Optional[PagedConfig] = None, device="cuda",
                   lead=()) -> Dict:
        """One layer's pool tree (leading axis: num_pages or slots,
        after ``lead``)."""

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        """Decode-state bytes per cached token per layer."""


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class KVFamily:
    name = "kv"
    constant_state = False

    def layer_pool(self, cfg, num_pages: int, page_size: int,
                   paged: Optional[PagedConfig] = None, device="cuda",
                   lead=()) -> Dict:
        shp = (*lead, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        if paged is not None and paged.quantize_kv:
            sshp = (*lead, num_pages, page_size, 1)
            return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                    "v": torch.zeros(shp, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshp, dtype=torch.float32,
                                           device=device),
                    "v_scale": torch.zeros(sshp, dtype=torch.float32,
                                           device=device)}
        dt = model_lib.dtype_of(cfg)
        return {"k": torch.zeros(shp, dtype=dt, device=device),
                "v": torch.zeros(shp, dtype=dt, device=device)}

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        if paged is not None and paged.quantize_kv:
            return 2 * (cfg.n_kv_heads * cfg.head_dim + 4)  # int8 + f32 scale
        return (2 * cfg.n_kv_heads * cfg.head_dim
                * _itemsize(model_lib.dtype_of(cfg)))


class MLAFamily:
    name = "mla"
    constant_state = False

    def layer_pool(self, cfg, num_pages: int, page_size: int,
                   paged: Optional[PagedConfig] = None, device="cuda",
                   lead=()) -> Dict:
        dt = model_lib.dtype_of(cfg)
        return {"c": torch.zeros((*lead, num_pages, page_size,
                                  cfg.mla_kv_lora), dtype=dt, device=device),
                "kpe": torch.zeros((*lead, num_pages, page_size,
                                    cfg.mla_qk_rope), dtype=dt,
                                   device=device)}

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        return ((cfg.mla_kv_lora + cfg.mla_qk_rope)
                * _itemsize(model_lib.dtype_of(cfg)))


class SRFFamily:
    name = "srf"
    constant_state = True

    def layer_pool(self, cfg, num_slots: int, page_size: int,
                   paged: Optional[PagedConfig] = None, device="cuda",
                   lead=()) -> Dict:
        m = attn_lib.srf_cfg(cfg).feat_dim
        dt = model_lib.dtype_of(cfg)
        return {"s": torch.zeros((*lead, num_slots, cfg.n_heads, m,
                                  attn_lib.v_dim(cfg)), dtype=dt,
                                 device=device),
                "z": torch.zeros((*lead, num_slots, cfg.n_heads, m),
                                 dtype=dt, device=device)}

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        m = attn_lib.srf_cfg(cfg).feat_dim
        item = _itemsize(model_lib.dtype_of(cfg))
        return cfg.n_heads * m * (attn_lib.v_dim(cfg) + 1) * item / max_len


class SSDFamily:
    name = "ssd"
    constant_state = True

    def layer_pool(self, cfg, num_slots: int, page_size: int,
                   paged: Optional[PagedConfig] = None, device="cuda",
                   lead=()) -> Dict:
        cache = ssm_lib.init_ssm_cache(cfg, num_slots,
                                       model_lib.dtype_of(cfg), device, lead)
        return {k: v for k, v in cache.items() if k != "idx"}

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        total = ((cfg.ssm_conv - 1) * ssm_lib.conv_dim(cfg)
                 * _itemsize(model_lib.dtype_of(cfg))
                 + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4)
        return total / max_len


FAMILIES = {f.name: f for f in (KVFamily(), MLAFamily(), SRFFamily(),
                                SSDFamily())}


def attn_family_for(cfg) -> CacheFamily:
    """The cache family of the (self-)attention component."""
    if cfg.attn_impl == "srf":
        return FAMILIES["srf"]
    if cfg.is_mla:
        return FAMILIES["mla"]
    return FAMILIES["kv"]


@dataclass(frozen=True)
class PoolPlan:
    """Resolved pool geometry of one config (see the reference):
    per decoder segment ``(layer_kind, layer_count, ((component,
    family_name), ...))``, the O(L) family if any, and the constant-state
    families."""
    name: str
    segments: Tuple[Tuple[str, int, Tuple[Tuple[str, str], ...]], ...]
    paged_family: Optional[str]
    attn_family: Optional[str]
    slot_families: Tuple[str, ...]
    has_memory: bool

    @property
    def has_paged(self) -> bool:
        return self.paged_family is not None

    @property
    def needs_slot(self) -> bool:
        return bool(self.slot_families) or self.has_memory

    @property
    def constant_state(self) -> bool:
        return not self.has_paged

    def bytes_per_token(self, cfg, max_len: int,
                        paged: Optional[PagedConfig] = None) -> float:
        """Per-layer decode-state bytes per token of the plan's
        families; the enc-dec memory slot amortized over ``max_len``
        like the other constant states."""
        fams = {f for _, _, comps in self.segments for _, f in comps}
        total = sum(FAMILIES[f].bytes_per_token(cfg, max_len, paged)
                    for f in sorted(fams))
        if self.has_memory:
            total += cfg.enc_len * cfg.d_model * \
                _itemsize(model_lib.dtype_of(cfg)) / max_len
        return total


def plan_for(cfg) -> PoolPlan:
    """The pool plan of a config, resolved from its layers' components:
    "attn" is ``kv``, ``mla`` or ``srf`` (``attn_family_for``), "ssm" is
    ``ssd``. The name joins the paged family and then the slot families
    in the order the layers name them ("kv+ssd", "srf+ssd", "ssd"); an
    enc-dec config adds its memory pool ("kv+mem", "srf+mem")."""
    segs = []
    paged_fam = attn_fam = None
    slot_fams: List[str] = []
    for kind, count, comps in model_lib._layer_plan(cfg):
        resolved = []
        for comp in comps:
            fam = attn_family_for(cfg) if comp == "attn" \
                else FAMILIES["ssd"]
            resolved.append((comp, fam.name))
            if comp == "attn":
                attn_fam = fam.name
            if not fam.constant_state:
                paged_fam = fam.name
            elif fam.name not in slot_fams:
                slot_fams.append(fam.name)
        segs.append((kind, count, tuple(resolved)))
    parts = ([paged_fam] if paged_fam else []) + slot_fams + \
        (["mem"] if cfg.is_encdec else [])
    return PoolPlan(name="+".join(parts), segments=tuple(segs),
                    paged_family=paged_fam, attn_family=attn_fam,
                    slot_families=tuple(slot_fams),
                    has_memory=cfg.is_encdec)


def family_for(cfg) -> CacheFamily:
    """The config's primary cache family: the attention component's for
    a stack with attention, ssd for pure SSM (the full geometry of a
    mixed stack is its :class:`PoolPlan`)."""
    plan = plan_for(cfg)
    if plan.attn_family is not None:
        return FAMILIES[plan.attn_family]
    return FAMILIES[plan.slot_families[0]]


def init_pools(cfg, num_pages: int, page_size: int, num_slots: int = 0,
               device="cuda", paged: Optional[PagedConfig] = None,
               mesh=None):
    """The full pool container (layout in the module docstring) on
    ``device``: ``num_pages`` sizes the paged domain, ``num_slots`` the
    slot domain (and the enc-dec memory pool: one contiguous row a
    slot, so a slot's memory is one page for paged_gather). Each
    segment's leaves carry a leading layer axis and are allocated whole
    (torch.zeros), so no two layers share storage.

    ``mesh``: lay the pools out on the mesh's ``model`` axis instead
    (``serving.mesh.shard.place_pools``: a ``ShardedTree``, or the plain
    container on the mesh's home device when the layout degrades to
    replication); ``device`` is then unused. The page tables stay
    host-side either way."""
    if mesh is not None:
        from repro_torch.serving.mesh import shard as mesh_shard
        meta = init_pools(cfg, num_pages, page_size, num_slots, "meta",
                          paged)
        return mesh_shard.place_pools(meta, cfg, mesh, paged)
    plan = plan_for(cfg)
    if plan.needs_slot:
        num_slots = max(num_slots, 2)
    pools: Dict = {"paged": [], "slot": []}
    for _, count, comps in plan.segments:
        pseg: Dict = {}
        sseg: Dict = {}
        for comp, fam_name in comps:
            fam = FAMILIES[fam_name]
            n = num_slots if fam.constant_state else num_pages
            (sseg if fam.constant_state else pseg)[comp] = fam.layer_pool(
                cfg, n, page_size, paged, device, lead=(count,))
        pools["paged"].append(pseg or None)
        pools["slot"].append(sseg or None)
    if plan.has_memory:
        pools["memory"] = torch.zeros(
            (num_slots, cfg.enc_len, cfg.d_model),
            dtype=model_lib.dtype_of(cfg), device=device)
    return pools


def home(pools) -> Dict:
    """The container the replicated part of a step reads: the pools
    themselves, or a sharded layout's first position's."""
    return pools.parts[0] if isinstance(pools, ShardedTree) else pools


def global_view(pools) -> Dict:
    """The pools with their GLOBAL shapes and dtypes: the pools
    themselves, or ``meta`` tensors standing for a sharded layout's
    global leaves (what the router's pool signature compares)."""
    if not isinstance(pools, ShardedTree):
        return pools
    from repro_torch.serving.mesh import shard as mesh_shard
    return _zip_containers(
        lambda spec, *parts: torch.empty(
            mesh_shard.global_shape(parts[0].shape, spec, len(parts)),
            dtype=parts[0].dtype, device="meta"),
        pools.specs, *pools.parts)


def _zip_containers(fn, specs, *parts):
    """``fn(spec, leaf of each part)`` over the container's leaves."""
    def seg_map(spec_segs, *segs):
        return [None if sp is None else
                {c: {k: fn(sp[c][k], *(s[c][k] for s in ss))
                     for k in sp[c]} for c in sp}
                for sp, ss in zip(spec_segs, zip(*segs))]
    out = {part: seg_map(specs[part], *(p[part] for p in parts))
           for part in ("paged", "slot")}
    if "memory" in specs:
        out["memory"] = fn(specs["memory"], *(p["memory"] for p in parts))
    return out


def _unique(tensors) -> Iterator[torch.Tensor]:
    seen = set()
    for a in tensors:
        if id(a) not in seen:
            seen.add(id(a))
            yield a


def _containers(pools) -> List[Dict]:
    return pools.parts if isinstance(pools, ShardedTree) else [pools]


def _leaves(segs) -> Iterator[torch.Tensor]:
    for seg in segs:
        if seg is not None:
            for comp in seg.values():
                yield from comp.values()


def _map_segs(segs, fn):
    return [None if seg is None else
            {c: {k: fn(a) for k, a in comp.items()} for c, comp in seg.items()}
            for seg in segs]


def _map_segs_pair(tree: Dict, fn) -> Dict:
    """``fn`` on every leaf of both domains, and on the memory rows."""
    out = {part: _map_segs(tree[part], fn) for part in ("paged", "slot")}
    if "memory" in tree:
        out["memory"] = fn(tree["memory"])
    return out


def _all_leaves(tree: Dict) -> Iterator[torch.Tensor]:
    yield from _leaves(tree["paged"])
    yield from _leaves(tree["slot"])
    if "memory" in tree:
        yield tree["memory"]


def _index(ids: List[int], a: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(list(ids), dtype=torch.long, device=a.device)


def _slice_one(pools: Dict, page_ids: List[int],
               slot_ids: List[int]) -> Dict:
    out = {"paged": _map_segs(pools["paged"],
                              lambda a: a[:, _index(page_ids, a)]),
           "slot": _map_segs(pools["slot"],
                             lambda a: a[:, _index(slot_ids, a)])}
    if "memory" in pools:
        out["memory"] = pools["memory"][_index(slot_ids, pools["memory"])]
    return out


def _slice_pools(pools, page_ids: List[int], slot_ids: List[int]) -> Dict:
    """Device copies of the given pages and slots of every pool, and of
    the slots' memory rows (advanced indexing gathers into fresh
    tensors); a sharded layout's rows are stitched into global rows."""
    if not isinstance(pools, ShardedTree):
        return _slice_one(pools, page_ids, slot_ids)
    from repro_torch.serving.mesh import shard as mesh_shard
    per = [_slice_one(p, page_ids, slot_ids) for p in pools.parts]
    return _zip_containers(
        lambda spec, *parts: mesh_shard.global_rows(list(parts), spec),
        pools.specs, *per)


class PendingSnapshot:
    """Copy-on-preempt snapshot whose device->host transfer overlaps the
    next steps.

    The page and slot rows are gathered on the device into fresh tensors
    (later in-place pool writes cannot clobber them), then copied into
    pinned host buffers with ``non_blocking=True`` and a CUDA event is
    recorded behind the copy (pageable host memory would make the copy
    synchronous). Every later pool write is queued on the same stream
    after the gather, so a page may be handed out again at once; the
    host copy is complete after :meth:`fence`, which :meth:`to_host`
    calls. On the CPU the copies are plain clones."""

    def __init__(self, slices: Dict):
        self._dev = slices
        self._event = None
        self._host = None
        if any(a.is_cuda for a in _all_leaves(slices)):
            self._host = _map_segs_pair(
                slices, lambda a: torch.empty(a.shape, dtype=a.dtype,
                                              pin_memory=True).copy_(
                    a, non_blocking=True))
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = _map_segs_pair(slices, lambda a: a.clone())
            self._dev = None

    def fence(self) -> None:
        """Block until the host copy has landed (then the device-side
        slices are dead to this snapshot)."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        self._dev = None

    def to_host(self) -> Dict:
        self.fence()
        return self._host

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in _all_leaves(self._host))


def snapshot_page_rows_async(pools: Dict, page_ids: List[int],
                             slot_ids: List[int]) -> PendingSnapshot:
    """Copy-on-preempt over both index domains (and the memory rows of
    an enc-dec request); the host transfer overlaps the steps that
    follow (see :class:`PendingSnapshot`)."""
    return PendingSnapshot(_slice_pools(pools, page_ids, slot_ids))


def pool_page_rows(pools: Dict, page_ids: List[int],
                   slot_ids: List[int]) -> Dict:
    """Synchronous snapshot: host (CPU) copies of the given rows."""
    return _map_segs_pair(_slice_pools(pools, page_ids, slot_ids),
                          lambda a: a.cpu())


def zero_slot_rows(pools, slot_ids: List[int],
                   zero_memory: bool = True):
    """Reset the given slots of every constant-state pool (and of the
    memory pool) to zero, in place, on every shard: SRF and SSD states
    are running accumulators (and the SSD conv tail a window of past
    inputs), so a re-issued slot must not carry the previous request's
    state. ``zero_memory=False`` leaves the memory rows, which the
    engine's encoder is about to overwrite whole."""
    cs = _containers(pools)
    for a in _unique(a for c in cs for a in _leaves(c["slot"])):
        a[:, _index(slot_ids, a)] = 0
    if zero_memory and "memory" in cs[0]:
        for mem in _unique(c["memory"] for c in cs):
            mem[_index(slot_ids, mem)] = 0
    return pools


def _restore_one(pools: Dict, page_ids: List[int], slot_ids: List[int],
                 snap: Dict) -> None:
    for part, ids in (("paged", page_ids), ("slot", slot_ids)):
        for seg, sseg in zip(pools[part], snap[part]):
            if seg is None:
                continue
            for c, comp in seg.items():
                for k, a in comp.items():
                    a[:, _index(ids, a)] = sseg[c][k].to(a.device, a.dtype)
    if "memory" in pools:
        mem = pools["memory"]
        mem[_index(slot_ids, mem)] = snap["memory"].to(mem.device, mem.dtype)


def restore_page_rows(pools, page_ids: List[int], slot_ids: List[int],
                      snap):
    """Inverse of the snapshot: write saved rows back into (freshly
    allocated) pages and slots, in place. Takes the host form of
    :func:`pool_page_rows` or a :class:`PendingSnapshot`; its rows are
    global, so a sharded layout takes each position's block of them."""
    if isinstance(snap, PendingSnapshot):
        snap = snap.to_host()
    if not isinstance(pools, ShardedTree):
        _restore_one(pools, page_ids, slot_ids, snap)
        return pools
    from repro_torch.serving.mesh import shard as mesh_shard
    blocks = _zip_containers(
        lambda spec, x: mesh_shard.split_rows(x, spec, pools.tp),
        pools.specs, snap)
    for i, part in enumerate(pools.parts):
        _restore_one(part, page_ids, slot_ids,
                     _zip_containers(lambda spec, b: b[i], pools.specs,
                                     blocks))
    return pools


def copy_page_rows(pools, src_ids: List[int], dst_ids: List[int]):
    """COW fork: copy page rows ``src -> dst`` in every paged-domain pool
    of every shard, in place. ``a[:, src]`` gathers every source into a
    fresh tensor before any write lands, so a destination that recycles
    a page freed in the same round never clobbers a source. (The
    reference pads the id lists to power-of-two buckets so that jax
    compiles few shapes; eager PyTorch compiles nothing, so there is no
    padding here.) Slot pools never fork."""
    if not src_ids:
        return pools
    for a in _unique(a for c in _containers(pools)
                     for a in _leaves(c["paged"])):
        a[:, _index(dst_ids, a)] = a[:, _index(src_ids, a)]
    return pools


def page_bytes(pools) -> int:
    """Device bytes ONE paged-domain page occupies across all layers and
    segments, globally (the prefix cache's byte-budget unit): leaves are
    shaped (L, num_pages, ...)."""
    return sum(a.numel() // a.shape[1] * a.element_size()
               for a in _leaves(global_view(pools)["paged"]))


def apply_moves(pools, moves: Dict[int, int]):
    """Apply a defrag plan {old: new} to every paged-domain pool, in
    place (slots never fragment)."""
    if moves:
        copy_page_rows(pools, list(moves), list(moves.values()))
    return pools


def pool_bytes(pools) -> int:
    """Bytes of every pool, the memory pool included (global: a sharded
    leaf counts all its blocks)."""
    return sum(a.numel() * a.element_size()
               for a in _all_leaves(global_view(pools)))


def memory_bytes(pools) -> int:
    """Bytes of the enc-dec memory pool (0 without one)."""
    mem = home(pools).get("memory")
    return 0 if mem is None else mem.numel() * mem.element_size()


def pool_bytes_per_device(pools) -> int:
    """Bytes one mesh position holds: its block of every sharded leaf and
    every replicated leaf whole (all pools, without a mesh). On a mesh
    of one card repeated, the card holds the positions' sum."""
    return sum(a.numel() * a.element_size() for a in _all_leaves(home(pools)))
