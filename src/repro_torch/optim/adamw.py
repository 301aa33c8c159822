"""AdamW with global-norm clipping and path-based weight-decay masking.

Port of ``repro.optim.adamw``: states are plain trees mirroring the
params, moments f32 whatever the param dtype, the reference's math
(clip by the global norm, bias-corrected moments, ``p - lr*(step +
wd*p)`` in f32, one cast back to the param dtype). Not
``torch.optim.AdamW``, which keeps its moments in the param's dtype and
applies the decay before the step.

``update`` writes params and moments IN PLACE, one leaf at a time, and
a leaf of more than ``UPDATE_CHUNK`` elements a block of leading-axis
rows at a time, so the f32 temporaries stay one block's size: the
untied head of a full-width model is 389 M elements, and a MoE
segment's stacked expert leaf (layers, experts, d, ffe) 7 x 184 M at 8
of moonshot's layers. The update is elementwise, so the blocks give the
same bits; only the gradient norm of such a leaf sums its blocks' sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


NO_DECAY_TOKENS = ("ln", "norm", "bias", "a_log", "dt_bias", "d_skip",
                   "fuse_n", "b_", "bq", "bk", "bv")


def decay_mask(params) -> Dict:
    """True where weight decay applies: no path token of
    ``NO_DECAY_TOKENS`` in the leaf's lower-cased path."""
    return tree_lib.map_with_path(
        lambda path, _: not any(t in path.lower() for t in NO_DECAY_TOKENS),
        params)


def init(params) -> Dict:
    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    count = tree_lib.leaves(params)[0]
    return {"mu": tree_lib.map(zeros, params),
            "nu": tree_lib.map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=count.device)}


UPDATE_CHUNK = 1 << 27       # elements of a leaf updated (or squared) at once


def _blocks(x: torch.Tensor):
    """Views of ``x`` of at most ``UPDATE_CHUNK`` elements (a block of
    leading-axis rows; a row is never split), or ``x`` itself when it is
    that small."""
    if x.numel() <= UPDATE_CHUNK or x.dim() == 0:
        return [x]
    rows = max(1, UPDATE_CHUNK // (x.numel() // x.shape[0]))
    return [x[i:i + rows] for i in range(0, x.shape[0], rows)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (None leaves,
    the gradients of integer params, count nothing; a leaf past
    ``UPDATE_CHUNK`` elements squared a block at a time)."""
    sq = [torch.sum(torch.square(b.float())) for x in tree_lib.leaves(tree)
          if x is not None for b in _blocks(x)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def update(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[Dict, Dict, Dict]:
    """-> (params, state, stats), params and moments updated in place
    (the same trees come back; ``state["count"]`` is a new tensor). A
    None gradient (an integer param: the seeds of seeded SRF) leaves its
    param and moments as they are."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    mask = tree_lib.leaves(decay_mask(params))
    for g, mu, nu, p, m in zip(tree_lib.leaves(grads),
                               tree_lib.leaves(state["mu"]),
                               tree_lib.leaves(state["nu"]),
                               tree_lib.leaves(params), mask):
        if g is None:
            continue
        for args in zip(*map(_blocks, (g, mu, nu, p))):
            _step(*args, m, scale, c1, c2, lr, cfg)
    return params, {"mu": state["mu"], "nu": state["nu"],
                    "count": count}, {"grad_norm": gnorm}


def _step(g, mu, nu, p, decay: bool, scale, c1, c2, lr,
          cfg: AdamWConfig) -> None:
    """One leaf's (or block's) AdamW step, ``mu``, ``nu`` and ``p`` in
    place."""
    g = g.float() * scale
    mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    del g
    step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    pf = p.float()
    if decay:
        step += cfg.weight_decay * pf
    p.copy_(pf - lr * step)
