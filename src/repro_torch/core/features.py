"""Feature maps phi of the paper: phi(v) = f(A_k ... A_1 v) / sqrt(m).

Port of ``repro.core.features`` (phi_scalar, phi_trig, phi_softmax_pos,
phi_softmax_trig). Every phi takes a ``spinner.SpinnerPipeline`` plus
its params tuple; the projection chain, f and the scaling run as one
fused spinner call per block. ``grouped=True`` runs G independent
pipelines (leading axis on x and on every param leaf) — the per-kv-head
layout of SRF attention.

Back-compat: a legacy ``pmodel.PModelSpec`` (+ a bare params dict) is
accepted with a ``DeprecationWarning`` and converted to the equivalent
1-block pipeline (``spinner.as_pipeline``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch

from . import spinner
from .spinner import SpinnerPipeline


# the paper's pointwise f's as functions of y, derived from the registry in
# core/spinner.py: identity (JL), heaviside (angular / arc-cosine b=0),
# sign (E[s1 s2] = 1 - 2 theta/pi), relu (arc-cosine b=1)

def _scalar_f(name: str) -> Callable:
    fn = spinner.nonlinearity(name).fn
    return lambda y: fn(y, None)


f_identity = _scalar_f("identity")
f_heaviside = _scalar_f("heaviside")
f_sign = _scalar_f("sign")
f_relu = _scalar_f("relu")

F_TABLE: Dict[str, Callable] = {
    "identity": f_identity,
    "heaviside": f_heaviside,
    "sign": f_sign,
    "relu": f_relu,
}


def _inv_sqrt_m(pipe: SpinnerPipeline) -> float:
    return float(pipe.m_out) ** -0.5


def phi_scalar(pipe: SpinnerPipeline, params, x: torch.Tensor,
               f: Union[str, Callable], grouped: bool = False
               ) -> torch.Tensor:
    """phi(x) = f(proj(x)) / sqrt(m); a registered scalar f is fused as
    the kernel epilogue, a callable runs after the projection."""
    pipe = spinner.as_pipeline(pipe)
    if isinstance(f, str):
        try:
            nl = spinner.nonlinearity(f)
        except ValueError as e:
            raise KeyError(str(e)) from None
        if nl.out_mult != 1 or nl.needs_input:
            raise KeyError(
                f"phi_scalar needs a scalar pointwise f, got {f!r} "
                "(use phi_softmax_pos / phi_trig for exp / cos_sin)")
        return pipe.with_f(f).apply(params, x, out_scale=_inv_sqrt_m(pipe),
                                    grouped=grouped)
    y = pipe.with_f("identity").apply(params, x, grouped=grouped)
    return f(y) / math.sqrt(pipe.m_out)


def phi_trig(pipe: SpinnerPipeline, params, x: torch.Tensor,
             sigma: float = 1.0, grouped: bool = False) -> torch.Tensor:
    """Gaussian-kernel features [cos(y/s), sin(y/s)] / sqrt(m) (dim 2m);
    a Python-number sigma fuses into the last block's call, a tensor
    sigma (learnable bandwidth) applies the scale and trig outside."""
    if isinstance(sigma, (int, float)):
        return pipe.with_f("cos_sin").apply(params, x,
                                            y_scale=1.0 / float(sigma),
                                            out_scale=_inv_sqrt_m(pipe),
                                            grouped=grouped)
    y = pipe.with_f("identity").apply(params, x, grouped=grouped) / sigma
    return torch.cat([torch.cos(y), torch.sin(y)], dim=-1) / \
        math.sqrt(pipe.m_out)


def phi_softmax_pos(pipe: SpinnerPipeline, params, x: torch.Tensor,
                    scale: float = 1.0, stabilize: bool = True,
                    grouped: bool = False) -> torch.Tensor:
    """Positive softmax-kernel features (FAVOR+ form; f = exp):
    phi(x) = exp(y - ||x||^2/2 - c) / sqrt(m),  y = proj(x * scale).

    ``stabilize=False`` (keys): exp(y - ||x||^2/2) runs fused in the
    kernel. ``stabilize=True`` (queries): the projection is fused, the
    overflow-safe exp(z - max z) runs outside.
    """
    pipe = spinner.as_pipeline(pipe)
    x = x * scale
    if not stabilize:
        return pipe.with_f("exp").apply(params, x,
                                        out_scale=_inv_sqrt_m(pipe),
                                        grouped=grouped)
    y = pipe.with_f("identity").apply(params, x, grouped=grouped)
    sq = 0.5 * torch.sum(x * x, dim=-1, keepdim=True)
    z = y - sq
    z = z - torch.amax(z, dim=-1, keepdim=True).detach()
    return torch.exp(z) / math.sqrt(pipe.m_out)


def phi_softmax_trig(pipe: SpinnerPipeline, params, x: torch.Tensor,
                     scale: float = 1.0, grouped: bool = False
                     ) -> torch.Tensor:
    """Trigonometric softmax features (paper Sec 2.1 ex. 3):
    exp(<q,k>) = e^{(|q|^2+|k|^2)/2} E[cos(y_q - y_k)]. Unbiased but
    signed."""
    pipe = spinner.as_pipeline(pipe)
    x = x * scale
    z = pipe.with_f("cos_sin").apply(params, x, out_scale=_inv_sqrt_m(pipe),
                                     grouped=grouped)
    sq = 0.5 * torch.sum(x * x, dim=-1, keepdim=True)
    return z * torch.exp(sq)
