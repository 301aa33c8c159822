"""Pooled, pre-allocated decode state for the paged engine.

Port of ``repro.serving.paged_cache`` for the ``srf`` family: the
paper's constant-size SRF attention state, one slot per request in the
*slot* index domain::

    srf   feature S (num_slots, Hq, m, dv) + norm z (num_slots, Hq, m)

The pool container keeps the reference's layout::

    {"paged": [None per segment],
     "slot":  [per-segment {"attn": {"s": (L, num_slots, Hq, m, dv),
                                     "z": (L, num_slots, Hq, m)}}]}

Slot 0 is the null slot padded batch rows write into. Pools are updated
in place by the model step; the helpers below (zero on reuse, snapshot
and restore around preemption) also act in place. The kv / mla / ssd
families and the prefix cache's page copies are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as model_lib


class SRFFamily:
    name = "srf"
    constant_state = True

    def layer_pool(self, cfg, num_slots: int, device, lead=()) -> Dict:
        m = attn_lib.srf_cfg(cfg).feat_dim
        dt = model_lib.dtype_of(cfg)
        return {"s": torch.zeros((*lead, num_slots, cfg.n_heads, m,
                                  cfg.head_dim), dtype=dt, device=device),
                "z": torch.zeros((*lead, num_slots, cfg.n_heads, m),
                                 dtype=dt, device=device)}

    def bytes_per_token(self, cfg, max_len: int) -> float:
        m = attn_lib.srf_cfg(cfg).feat_dim
        item = torch.empty((), dtype=model_lib.dtype_of(cfg)).element_size()
        return cfg.n_heads * m * (cfg.head_dim + 1) * item / max_len


FAMILIES = {"srf": SRFFamily()}


@dataclass(frozen=True)
class PoolPlan:
    """Resolved pool geometry of one config (see the reference)."""
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

    def bytes_per_token(self, cfg, max_len: int) -> float:
        return FAMILIES["srf"].bytes_per_token(cfg, max_len)


def plan_for(cfg) -> PoolPlan:
    """The pool plan of a config; only SRF attention is ported."""
    if cfg.attn_impl != "srf":
        raise NotImplementedError(
            f"{cfg.attn_impl!r} attention pools are "
            f"{attn_lib.NOT_IN_SLICE}")
    segs = tuple((kind, count, (("attn", "srf"),))
                 for kind, count, _ in model_lib._layer_plan(cfg))
    return PoolPlan(name="srf", segments=segs, paged_family=None,
                    attn_family="srf", slot_families=("srf",),
                    has_memory=False)


def init_pools(cfg, num_pages: int, page_size: int, num_slots: int = 0,
               device="cuda") -> Dict:
    """The full pool container (layout in the module docstring);
    ``num_pages`` and ``page_size`` size the paged domain, which the SRF
    family does not use."""
    plan = plan_for(cfg)
    num_slots = max(num_slots, 2)
    pools: Dict = {"paged": [], "slot": []}
    for _, count, _ in plan.segments:
        pools["paged"].append(None)
        pools["slot"].append({"attn": FAMILIES["srf"].layer_pool(
            cfg, num_slots, device, lead=(count,))})
    return pools


def _slot_leaves(pools: Dict):
    for seg in pools["slot"]:
        if seg is not None:
            for comp in seg.values():
                yield from comp.items()


def zero_slot_rows(pools: Dict, slot_ids: List[int]) -> Dict:
    """Reset the given slots of every constant-state pool to zero, in
    place: SRF states are running accumulators, so a re-issued slot must
    not carry the previous request's state."""
    idx = torch.as_tensor(slot_ids, dtype=torch.long)
    for _, a in _slot_leaves(pools):
        a[:, idx.to(a.device)] = 0
    return pools


def snapshot_slot_rows(pools: Dict, slot_ids: List[int]) -> List[Dict]:
    """Copy-on-preempt: host copies of the given slots of every segment."""
    idx = torch.as_tensor(slot_ids, dtype=torch.long)
    return [None if seg is None else
            {c: {k: a[:, idx.to(a.device)].cpu() for k, a in comp.items()}
             for c, comp in seg.items()} for seg in pools["slot"]]


def restore_slot_rows(pools: Dict, slot_ids: List[int], snap) -> Dict:
    """Inverse of :func:`snapshot_slot_rows`, into (fresh) slots."""
    idx = torch.as_tensor(slot_ids, dtype=torch.long)
    for seg, sseg in zip(pools["slot"], snap):
        if seg is None:
            continue
        for c, comp in seg.items():
            for k, a in comp.items():
                a[:, idx.to(a.device)] = sseg[c][k].to(a.device, a.dtype)
    return pools


def pool_bytes(pools: Dict) -> int:
    return sum(a.numel() * a.element_size() for _, a in _slot_leaves(pools))
