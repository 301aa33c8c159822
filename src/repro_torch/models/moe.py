"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch,
shared experts (DeepSeek style), the switch load-balance aux loss.

Port of ``repro.models.moe``: ``moe_init``, ``moe_apply`` and the O(T·E)
oracle ``moe_dense_reference``, plain PyTorch throughout (the reference
computes them with jnp einsums, outside any Pallas kernel).

Dispatch is group-local, as in the reference: each batch row is a group
with its own capacity ``cap = max(8, ceil8(int(cf · L · k / E)))`` for a
call of length L (a prefill chunk, a whole prompt, or 1 at decode).
Slot positions come from per-expert running counts over the k routing
slots in turn; slots past the capacity are dropped. The int slot map
(B, E, cap) of token ids (L = the empty slot) gathers each expert's
payload rows into a (B, E, cap, d) buffer, the SwiGLU experts run
batched over (group, expert), and each token sums its kept slots'
gate-weighted outputs back.

Two deliberate differences from the reference, neither of which changes
the integer routing:

* top-k ties go to the lower expert index first, as ``jax.lax.top_k``
  breaks them (``torch.topk`` makes no such promise): the k largest are
  taken from a stable descending sort.
* the combine is a gather: token t sums its k slots' outputs in routing
  order j = 0..k-1, where the reference scatter-adds the (E, cap) slot
  rows onto tokens. A CUDA scatter-add sums with atomics, so its result
  would change from run to run in bf16 (and would raise or slow down
  under ``torch.use_deterministic_algorithms``); the gather gives the same
  bits on every run. The two orders agree within f32 rounding
  (``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import hooks, layers


def _normal(gen: torch.Generator, shape, scale: float, dtype, device,
            lead=()) -> torch.Tensor:
    """N(0, scale²) of ``shape`` under ``lead``, drawn one leading index
    at a time in f32 into a preallocated ``dtype`` tensor: the f32
    temporaries stay one layer's size (a full-width stacked expert leaf
    is 8.7 G elements)."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for i in itertools.product(*map(range, lead)):
        out[i] = (torch.randn(shape, generator=gen, device=device)
                  * scale).to(dtype)
    return out


def moe_init(gen: torch.Generator, cfg, dtype, device=None,
             lead=()) -> Dict:
    """Router (d, E), kept in f32 whatever the model's dtype; experts
    "wi", "wg" (E, d, ffe) and "wo" (E, ffe, d); and the shared experts'
    SwiGLU ("shared") when ``cfg.moe_shared`` > 0. ``lead`` stacks a
    leading layer axis."""
    d, e, ffe = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    s = 1.0 / math.sqrt(d)
    p = {"router": _normal(gen, (d, e), s, torch.float32, device, lead),
         "wi": _normal(gen, (e, d, ffe), s, dtype, device, lead),
         "wg": _normal(gen, (e, d, ffe), s, dtype, device, lead),
         "wo": _normal(gen, (e, ffe, d), 1.0 / math.sqrt(ffe), dtype,
                       device, lead)}
    if cfg.moe_shared > 0:
        p["shared"] = layers.mlp_init(gen, d, cfg.moe_shared * ffe, dtype,
                                      device, lead)
    return p


def capacity(cfg, length: int) -> int:
    """Slots per expert and group for a call of ``length`` tokens."""
    cap = int(cfg.moe_capacity_factor * length * cfg.moe_top_k
              / cfg.moe_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, ties to the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, cfg, x: torch.Tensor, valid: Optional[torch.Tensor] = None
          ) -> Dict[str, torch.Tensor]:
    """The routing of (B, L, d) tokens: f32 router ``probs`` (B, L, E);
    top-k ``gates`` (renormalized, zero where ``valid`` is False) and
    expert ids ``idx`` (B, L, k); slot positions ``pos`` (B, L, k),
    sequential over the k routing slots in turn; ``keep`` (B, L, k), the
    slots inside capacity of valid tokens; ``cap``."""
    b, l, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    if valid is not None:
        gates = gates * valid[..., None].to(gates.dtype)
    pos = []
    base = torch.zeros((b, 1, e), dtype=torch.long, device=x.device)
    for j in range(k):
        oh = F.one_hot(idx[:, :, j], e)                       # (B, L, E)
        if valid is not None:
            oh = oh * valid[..., None]
        before = oh.cumsum(dim=1) - oh + base
        pos.append((before * oh).sum(dim=-1))                 # (B, L)
        base = base + oh.sum(dim=1, keepdim=True)
    pos = torch.stack(pos, dim=2)
    cap = capacity(cfg, l)
    keep = pos < cap
    if valid is not None:
        keep = keep & valid[..., None]
    return {"probs": probs, "gates": gates, "idx": idx, "pos": pos,
            "keep": keep, "cap": cap}


def slot_map(r: Dict[str, torch.Tensor], length: int) -> torch.Tensor:
    """(B, E, cap) token id of every expert slot; ``length`` (one past
    the last token) marks an empty slot."""
    idx, pos, keep, cap = r["idx"], r["pos"], r["keep"], r["cap"]
    b, l, k = idx.shape
    e = r["probs"].shape[-1]
    flat = torch.where(keep, idx * cap + pos, e * cap)        # e*cap: drop
    tok = torch.arange(l, device=idx.device)[None, :, None].expand(b, l, k)
    st = torch.full((b, e * cap + 1), length, dtype=torch.long,
                    device=idx.device)
    st.scatter_(1, flat.reshape(b, -1), tok.reshape(b, -1))
    return st[:, :-1].view(b, e, cap)


def moe_apply(p, cfg, x: torch.Tensor, valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> (out (B, L, d), aux loss).

    ``valid``: optional (B, L) bool; tokens marked False take no slot,
    use no capacity and get zero gates (the paged step passes its
    q_valid, so padded chunk rows cannot shift real tokens' slots)."""
    b, l, d = x.shape
    r = route(p, cfg, x, valid)
    idx, keep, cap = r["idx"], r["keep"], r["cap"]
    st = slot_map(r, l)
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=x.device)[:, None, None]
    buf = hooks.constrain(xpad[rows, st], "moe_buf")          # (B, E, C, d)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"])) * \
        torch.einsum("becd,edf->becf", buf, p["wi"])
    y = hooks.constrain(torch.einsum("becf,efd->becd", h, p["wo"]),
                        "moe_buf")
    # combine: each token's kept slots, gathered and summed in a fixed
    # order (the gate cast to y's dtype before the product, as in the
    # reference)
    e = cfg.moe_experts
    at = (torch.arange(b, device=x.device)[:, None, None] * e + idx) * cap \
        + torch.where(keep, r["pos"], 0)
    ys = y.reshape(b * e * cap, d)[at.reshape(-1)].view(b, l, -1, d)
    w = (r["gates"] * keep).to(y.dtype)
    out = torch.zeros((b, l, d), dtype=y.dtype, device=x.device)
    for j in range(idx.shape[-1]):
        out = out + torch.where(keep[..., j, None],
                                ys[:, :, j] * w[..., j, None], 0)
    if cfg.moe_shared > 0:
        out = out + layers.mlp(p["shared"], x.reshape(-1, d)).reshape(b, l, d)
    me = r["probs"].mean(dim=(0, 1))
    ce = F.one_hot(idx[:, :, 0], e).float().mean(dim=(0, 1))
    return out, e * torch.sum(me * ce)


def moe_dense_reference(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """O(T·E) oracle: every expert on every token, weighted by the same
    renormalized top-k gates, no capacity drops."""
    b, l, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    gates, idx = _top_k(probs, cfg.moe_top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    w = torch.zeros_like(probs).scatter(1, idx, gates)
    h = F.silu(torch.einsum("td,edf->tef", xf, p["wg"])) * \
        torch.einsum("td,edf->tef", xf, p["wi"])
    y = torch.einsum("tef,efd->ted", h, p["wo"])
    out = torch.einsum("te,ted->td", w.to(y.dtype), y)
    if cfg.moe_shared > 0:
        out = out + layers.mlp(p["shared"], xf)
    return out.reshape(b, l, d)
