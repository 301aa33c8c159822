"""DEPRECATED back-compat shim: the single-block P-model API.

Port of ``repro.core.pmodel``. A ``PModel`` is exactly a 1-block
``SpinnerPipeline`` (one structured block ``A . D1 H D0`` + a fused
nonlinearity); everything here delegates to ``core/spinner.py``:

    old                                   new
    ------------------------------------  -----------------------------------
    PModelSpec(kind, m, n, ...)           spinner.single(kind, m, n, ...)
    pmodel.init(gen, spec)                pipe.init(gen)      (params tuple)
    pmodel.project(spec, params, x)       pipe.apply(params, x)
    pmodel.project_fused(..., epilogue=f) pipe.with_f(f).apply(params, x, ...)
    pmodel.materialize(spec, params)      pipe.materialize(params)
    pmodel.row_gaussianity_moments(...)   pipe.row_gaussianity_moments(...)

``init/project/project_fused`` emit ``DeprecationWarning``; outputs equal
the pipeline API's for the same generator state (a 1-block pipeline's
init draws exactly what the legacy init drew).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict

import torch

from . import spinner, structured, transforms


def _warn(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.core.pmodel.{old} is deprecated; use {new} "
                  "(see core/README.md migration table)",
                  DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class PModelSpec:
    """Legacy 1-block spec. Prefer ``spinner.single`` / ``SpinnerBlock``."""
    kind: str = "circulant"       # one of structured.KINDS
    m: int = 128                  # output (embedding) dimension
    n: int = 128                  # input dimension (pow2 if use_hd)
    r: int = 1                    # displacement rank (ldr only)
    use_hd: bool = True           # paper Step 1 preconditioner
    ldr_nnz: int = 4

    def __post_init__(self):
        if self.kind not in structured.KINDS:
            raise ValueError(f"kind must be one of {structured.KINDS}")
        if self.use_hd and not transforms.is_pow2(self.n):
            raise ValueError(f"use_hd requires power-of-two n, got {self.n}")

    @property
    def block(self) -> spinner.SpinnerBlock:
        return spinner.SpinnerBlock(self.kind, self.m, self.n, self.r,
                                    self.use_hd, self.ldr_nnz)

    @property
    def pipeline(self) -> spinner.SpinnerPipeline:
        """The equivalent 1-block SpinnerPipeline (identity f)."""
        return spinner.SpinnerPipeline((self.block,))

    @property
    def budget(self) -> int:
        """t — the number of Gaussians recycled into the m x n projection."""
        return self.block.budget

    @property
    def storage(self) -> int:
        return self.block.storage


def init(gen: torch.Generator, spec: PModelSpec, dtype=torch.float32,
         device=None) -> Dict[str, torch.Tensor]:
    _warn("init", "SpinnerPipeline.init")
    return spec.pipeline.init(gen, dtype, device)[0]


def project(spec: PModelSpec, params: Dict[str, torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., m):  A . D1 H D0 . x."""
    _warn("project", "SpinnerPipeline.apply")
    return spec.pipeline.apply((params,), x)


def project_fused(spec: PModelSpec, params: Dict[str, torch.Tensor],
                  x: torch.Tensor, epilogue: str = "identity",
                  y_scale: float = 1.0, out_scale: float = 1.0,
                  grouped: bool = False) -> torch.Tensor:
    """One-pass  f(y_scale * A D1 H D0 x) * out_scale."""
    _warn("project_fused", "SpinnerPipeline.with_f(f).apply")
    return spec.pipeline.with_f(epilogue).apply(
        (params,), x, y_scale=y_scale, out_scale=out_scale, grouped=grouped)


def materialize(spec: PModelSpec, params: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """Dense (m, n) matrix of the *whole* pipeline A . D1 H D0 (oracle)."""
    return spec.pipeline.materialize((params,))


def row_gaussianity_moments(spec: PModelSpec,
                            params: Dict[str, torch.Tensor]):
    """Diagnostic: per-row mean/var of A (each row must be ~N(0, I) by the
    normalization property, Def. 1)."""
    return spec.block.row_gaussianity_moments(params)
