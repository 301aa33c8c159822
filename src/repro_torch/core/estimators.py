"""Closed-form kernels Lambda_f and their structured estimators (paper Sec 2.1).

Port of ``repro.core.estimators``. Closed forms (k=2, beta=product,
Psi=mean, r ~ N(0, I_n)):

  identity   E[<r,v1><r,v2>]            = <v1, v2>               (JL / ex. 1)
  heaviside  E[1{y1>=0} 1{y2>=0}]       = (pi - theta) / (2 pi)  (ex. 2*)
  sign       E[sgn(y1) sgn(y2)]         = 1 - 2 theta / pi
  relu       E[relu(y1) relu(y2)]       = |v1||v2| (sin t + (pi-t) cos t)/(2 pi)
                                          (arc-cosine b=1, Cho & Saul)
  trig       E[cos((y1-y2)/s)]          = exp(-||v1-v2||^2/(2 s^2))  (Gaussian)
  softmax    E[phi+(v1) phi+(v2)]       = exp(<v1, v2>)

(*) The paper states theta/(2pi) for the angular example; the product-form
expectation is (pi-theta)/(2pi) — theta/(2pi) is half the Hamming/hashing
distance E[(h1-h2)^2]/2. Both are exposed.

The structured estimate runs the feature maps of ``core.features``, so on
the card every block is one spinner kernel launch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from . import features, spinner
from .spinner import SpinnerPipeline


def angle(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    c = torch.sum(v1 * v2, -1) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1))
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


# --- exact closed forms -------------------------------------------------------

def k_inner(v1, v2):
    return torch.sum(v1 * v2, -1)


def k_angular_product(v1, v2):
    """E[h(y1) h(y2)], h = heaviside:  (pi - theta)/(2 pi)."""
    return (math.pi - angle(v1, v2)) / (2 * math.pi)


def k_angular_paper(v1, v2):
    """theta/(2 pi) — the quantity the paper's ex. 2 names Lambda_f."""
    return angle(v1, v2) / (2 * math.pi)


def k_sign(v1, v2):
    return 1.0 - 2.0 * angle(v1, v2) / math.pi


def k_arccos1(v1, v2):
    """Arc-cosine kernel b=1 (Cho & Saul '09): |v1||v2| J1(theta)/(2 pi),
    J1(t) = sin t + (pi - t) cos t."""
    t = angle(v1, v2)
    n1 = torch.linalg.norm(v1, dim=-1)
    n2 = torch.linalg.norm(v2, dim=-1)
    return n1 * n2 * (torch.sin(t) + (math.pi - t) * torch.cos(t)) / \
        (2 * math.pi)


def k_gaussian(v1, v2, sigma: float = 1.0):
    d2 = torch.sum((v1 - v2) ** 2, -1)
    return torch.exp(-d2 / (2.0 * sigma ** 2))


def k_softmax(v1, v2):
    return torch.exp(torch.sum(v1 * v2, -1))


EXACT: Dict[str, Callable] = {
    "identity": k_inner,
    "heaviside": k_angular_product,
    "sign": k_sign,
    "relu": k_arccos1,
    "trig": k_gaussian,
    "softmax": k_softmax,
}


# --- structured estimators ------------------------------------------------------

def estimate(pipe: SpinnerPipeline, params, fname: str, v1: torch.Tensor,
             v2: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Lambda_f^struct(v1, v2) = <phi(v1), phi(v2)>  (eq. 13).

    ``pipe``: a SpinnerPipeline of any depth (legacy PModelSpec still
    accepted, deprecated — see spinner.as_pipeline). v1, v2: (..., n)
    on the params' device.
    """
    pipe = spinner.as_pipeline(pipe)
    if fname == "trig":
        p1 = features.phi_trig(pipe, params, v1, sigma)
        p2 = features.phi_trig(pipe, params, v2, sigma)
    elif fname == "softmax":
        p1 = features.phi_softmax_pos(pipe, params, v1, stabilize=False)
        p2 = features.phi_softmax_pos(pipe, params, v2, stabilize=False)
    else:
        p1 = features.phi_scalar(pipe, params, v1, fname)
        p2 = features.phi_scalar(pipe, params, v2, fname)
    return torch.sum(p1 * p2, -1)


def exact(fname: str, v1, v2, sigma: float = 1.0):
    if fname == "trig":
        return k_gaussian(v1, v2, sigma)
    return EXACT[fname](v1, v2)


def mc_error(gen: torch.Generator, pipe: SpinnerPipeline, fname: str, v1,
             v2, n_trials: int = 32, sigma: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (population) std of the absolute estimation error over
    ``n_trials`` fresh pipeline draws from ``gen`` (on the generator's
    device; v1, v2 must lie there too)."""
    pipe = spinner.as_pipeline(pipe)
    want = exact(fname, v1, v2, sigma)
    errs = torch.stack([
        torch.abs(estimate(pipe, pipe.init(gen), fname, v1, v2, sigma) - want)
        for _ in range(n_trials)])
    return errs.mean(), errs.std(unbiased=False)
