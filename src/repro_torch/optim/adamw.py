"""AdamW with global-norm clipping and path-based weight-decay masking.

Port of ``repro.optim.adamw``: states are plain trees mirroring the
params, moments f32 whatever the param dtype, the reference's math
(clip by the global norm, bias-corrected moments, ``p - lr*(step +
wd*p)`` in f32, one cast back to the param dtype). Not
``torch.optim.AdamW``, which keeps its moments in the param's dtype and
applies the decay before the step.

``update`` writes params and moments IN PLACE, one leaf at a time, so
at most one leaf's f32 temporaries exist at once (the untied head of a
full-width model is 389 M elements).
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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (None leaves,
    the gradients of integer params, count nothing)."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree)
          if x is not None]
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
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        pf = p.float()
        if m:
            step += cfg.weight_decay * pf
        p.copy_(pf - lr * step)
    return params, {"mu": state["mu"], "nu": state["nu"],
                    "count": count}, {"grad_norm": gnorm}
