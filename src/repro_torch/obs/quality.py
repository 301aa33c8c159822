"""Live embedding-quality probe: the paper's row statistics sampled
from *serving* params.

Port of ``repro.obs.quality``. The probe samples the cheap Def. 1 row
statistics — per-row mean and variance of the materialized structured
block, which must look N(0, I)-row-like for the concentration theorem
(Thm 10) to hold — from one representative (layer, kv head) of the live
SRF pipeline params, on the params' device; the engine publishes them
as the ``srf_quality`` gauge (stats ``srf_row_mean_abs_max`` /
``srf_row_var_err_max``) and raises a ``quality_drift`` event when they
leave ``DRIFT_TOL``. A probe materializes one (m, n) block per pipeline
block and syncs with the device once.

The coherence-graph parameters (``core.coherence.pmodel_stats``, a
jacobian per block) stay behind ``full=True``, for offline use.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

#: Default drift tolerance on the Def. 1 row moments: rows of a healthy
#: structured block are ~N(0, 1), so |row mean| and |row var - 1| both
#: sit well under this for any calibrated pipeline.
DRIFT_TOL = 0.5


def moments_drifted(stats: Optional[Dict[str, float]],
                    tol: float = DRIFT_TOL) -> bool:
    """Whether a probe's row-gaussianity moments are out of tolerance
    (the engine emits a ``quality_drift`` registry event when so)."""
    if not stats:
        return False
    return (stats.get("srf_row_mean_abs_max", 0.0) > tol
            or stats.get("srf_row_var_err_max", 0.0) > tol)


def _find_srf_params(params):
    """First layer's per-head SRF pipeline params inside a serving
    param tree (leaves stacked (layers, heads, ...)), or None."""
    for seg in params.get("segments", []):
        attn = seg.get("attn") if isinstance(seg, dict) else None
        if isinstance(attn, dict) and "srf" in attn:
            return attn["srf"]
    return None


def _pick(t: torch.Tensor, layer: int, head: int) -> torch.Tensor:
    """One (layer, head) leaf, float leaves in f32 (seed leaves as they
    are: the seeded block regenerates its params from them)."""
    t = t[layer, head]
    return t.float() if t.is_floating_point() else t


def srf_quality_probe(cfg, params, full: bool = False, layer: int = 0,
                      head: int = 0) -> Optional[Dict[str, float]]:
    """Row-statistics report for the SRF embedding a live engine serves.

    Returns None for non-SRF configs. Cheap by default (one block
    materialization per pipeline block, no jacobians):

      srf_row_mean_abs_max — max over blocks of max |row mean|
      srf_row_var_err_max  — max over blocks of max |row var - 1|

    ``full=True`` adds chi / mu / mu~ per block via
    ``core.coherence.block_stats`` (EXPENSIVE: a jacobian over the
    budget of randomness; offline use only).
    """
    if getattr(cfg, "attn_impl", None) != "srf":
        return None
    sp = _find_srf_params(params)
    if sp is None:
        return None
    from repro_torch.models.attention import srf_cfg   # lazy: avoid cycles
    pipe = srf_cfg(cfg).pipeline
    # one representative (layer, head): quality parameters are identical
    # in distribution across heads (independent same-spec pipelines)
    one = tuple({k: _pick(v, layer, head) for k, v in blk.items()}
                for blk in sp)
    moments = pipe.row_gaussianity_moments(one)
    mean_abs = torch.stack([m.abs().max() for m, _ in moments]).max()
    var_err = torch.stack([(v - 1.0).abs().max() for _, v in moments]).max()
    mean_abs, var_err = torch.stack([mean_abs, var_err]).tolist()
    out = {"srf_row_mean_abs_max": mean_abs,
           "srf_row_var_err_max": var_err}
    if full:
        from repro_torch.core import coherence
        for i, (blk, p) in enumerate(zip(pipe.blocks, one)):
            st = coherence.block_stats(blk, p)
            for k in ("chi", "mu", "mu_tilde"):
                out[f"block{i}_{k}"] = st[k]
    return out
