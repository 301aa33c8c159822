"""Dispatchers between the CUDA kernels and their plain PyTorch versions.

Counterpart of ``repro.kernels.ops``: the spinner, the seeded spinner,
SRF decode, the two paged gathers, the Walsh-Hadamard transform and the
block-circulant projection. Routing follows where the tensor lies:

* a CUDA tensor goes to the kernel, or raises if the kernel refuses it —
  there is no fallback that hides a kernel failure;
* a CPU tensor goes to the plain version in ``kernels.ref``;
* what the spinner kernels do not take (kind ``ldr``, HD with a
  non-power-of-two n, n > 8192 — the reference's ``pallas_ok`` rule)
  goes to the plain version on either device, and on the card such a
  call is counted in ``spinner_project.plain_calls`` (seeded:
  ``spinner_project_seeded.plain_calls``);
* an fwht with n > ``fwht.MAX_N`` (16384, the reference kernel's
  Kronecker range) goes to the plain version on either device, and on
  the card such a call is counted in ``fwht.plain_calls``. The
  circulant kernel takes every valid call (any n, m <= nb * n): it has
  no such rule.

There is no interpret route and no block-size plan cache: block sizes
are the kernels' own. Launch counts live on the kernel wrappers
(``spinner.spinner_project_cuda.launches``,
``spinner.spinner_project_seeded_cuda.launches``,
``srf_decode.srf_decode_cuda.launches``,
``paged_gather.paged_gather_cuda.launches``,
``paged_gather.paged_gather_dequant_cuda.launches``,
``fwht.fwht_cuda.launches``,
``circulant.circulant_project_cuda.launches``);
:func:`launch_counts` reads them and :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import transforms

from . import circulant as _circ
from . import fwht as _fwht
from . import paged_gather as _pg
from . import ref as _ref
from . import spinner as _spin
from . import srf_decode as _dec


def launch_counts() -> Dict[str, int]:
    return {"spinner": _spin.spinner_project_cuda.launches,
            "srf_decode": _dec.srf_decode_cuda.launches,
            "paged_gather": _pg.paged_gather_cuda.launches,
            "paged_gather_dequant": _pg.paged_gather_dequant_cuda.launches,
            "spinner_seeded": _spin.spinner_project_seeded_cuda.launches,
            "spinner_plain_on_cuda": spinner_project.plain_calls,
            "spinner_seeded_plain_on_cuda":
                spinner_project_seeded.plain_calls,
            "fwht": _fwht.fwht_cuda.launches,
            "fwht_plain_on_cuda": fwht.plain_calls,
            "circulant_project": _circ.circulant_project_cuda.launches}


def reset_counts() -> None:
    _spin.spinner_project_cuda.launches = 0
    _dec.srf_decode_cuda.launches = 0
    _pg.paged_gather_cuda.launches = 0
    _pg.paged_gather_dequant_cuda.launches = 0
    _spin.spinner_project_seeded_cuda.launches = 0
    spinner_project.plain_calls = 0
    spinner_project_seeded.plain_calls = 0
    _fwht.fwht_cuda.launches = 0
    fwht.plain_calls = 0
    _circ.circulant_project_cuda.launches = 0


def fwht(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """(..., n) -> (..., n) Walsh-Hadamard transform (Sylvester order, n a
    power of two), scaled by 1/sqrt(n) when ``normalized``; f32
    arithmetic, one cast to x's dtype."""
    n = x.shape[-1]
    if not transforms.is_pow2(n):
        raise ValueError(f"fwht needs power-of-two length, got {n}")
    rows = x.reshape(-1, n)
    if x.is_cuda and n <= _fwht.MAX_N:
        y = _fwht.fwht_cuda(rows.contiguous(), normalized)
    else:
        if x.is_cuda:
            fwht.plain_calls += 1
        y = _ref.fwht_ref(rows, normalized)
    return y.reshape(x.shape)


fwht.plain_calls = 0


def circulant_project(g: torch.Tensor, x: torch.Tensor, m: int,
                      epilogue: str = "identity",
                      sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-circulant projection f(x . A^T), A regenerated from the (nb, n)
    generators g: x (B, n) -> (B, m), or (B, 2m) = [cos | sin] for
    cos_sin; ``sq`` (B,) is the subtrahend of exp (exp(y - sq))."""
    if epilogue not in _ref.CIRCULANT_EPILOGUES:
        raise ValueError(f"circulant_project: epilogue {epilogue!r} not in "
                         f"{_ref.CIRCULANT_EPILOGUES}")
    nb, n = g.shape
    if nb * n < m:
        raise ValueError(f"generators cover {nb * n} rows < m={m}")
    if x.is_cuda:
        return _circ.circulant_project_cuda(g.contiguous(), x.contiguous(),
                                            m, epilogue, sq)
    return _ref.circulant_project_ref(g, x, m, epilogue, sq)


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (N, P, D), tables (R, M) -> (R, M*P, D) contiguous history."""
    if pool.is_cuda:
        return _pg.paged_gather_cuda(pool, tables)
    return _ref.paged_gather_ref(pool, tables)


def paged_gather_dequant(pool: torch.Tensor, scales: torch.Tensor,
                         tables: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """int8 pool (N, P, D) + scales (N, P, 1), tables (R, M) ->
    (R, M*P, D) dequantized history in ``out_dtype``."""
    if pool.is_cuda:
        return _pg.paged_gather_dequant_cuda(pool, scales, tables, out_dtype)
    return _ref.paged_gather_dequant_ref(pool, scales, tables, out_dtype)


def srf_decode(s: torch.Tensor, z: torch.Tensor, phi_q: torch.Tensor,
               phi_k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s', z', out); see ``kernels.ref.srf_decode_ref`` for shapes. On
    the card s and z are updated in place (the returned s', z' are s, z);
    callers pass state they own and use the returned tensors."""
    if s.is_cuda:
        return _dec.srf_decode_cuda(s, z, phi_q, phi_k, v, eps)
    return _ref.srf_decode_ref(s, z, phi_q, phi_k, v, eps)


def kernel_takes(kind: str, n: int, m: int, use_hd: bool) -> bool:
    """The reference's ``pallas_ok`` rule (repro/kernels/ops.py)."""
    return (kind in _spin.KERNEL_KINDS
            and (not use_hd or transforms.is_pow2(n))
            and n <= _spin.MAX_N and n + m - 1 <= (1 << 22))


def spinner_project(kind: str, params: Dict[str, torch.Tensor],
                    x: torch.Tensor, m: int, epilogue: str = "identity",
                    y_scale: float = 1.0, out_scale: float = 1.0,
                    grouped: bool = False) -> torch.Tensor:
    """One-pass  f(y_scale · A · D1 H D0 · x) · out_scale  for any P-model.

    params: {"g", optional "h", "d0", "d1"}; HD applies iff "d0" is
    present. x: (..., n), or (G, ..., n) with ``grouped=True`` and a
    leading group axis G on every param leaf (per-kv-head P-models of SRF
    attention run as one launch). Output (..., m), or (..., 2m) =
    [cos | sin] for cos_sin.
    """
    g = params["g"]
    h: Optional[torch.Tensor] = params.get("h")
    d0: Optional[torch.Tensor] = params.get("d0")
    d1: Optional[torch.Tensor] = params.get("d1")
    n = x.shape[-1]
    xf = _groups(x, grouped)
    if not grouped:
        g = g[None]
        h = None if h is None else h[None]
        d0 = None if d0 is None else d0[None]
        d1 = None if d1 is None else d1[None]
    if x.is_cuda and kernel_takes(kind, n, m, d0 is not None):
        y = _spin.spinner_project_cuda(
            kind, g.contiguous(), xf.contiguous(), m,
            d0=None if d0 is None else d0.contiguous(),
            d1=None if d1 is None else d1.contiguous(),
            epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
    else:
        if x.is_cuda:
            spinner_project.plain_calls += 1
        y = _ref.spinner_project_ref(kind, g, xf, m, d0=d0, d1=d1, h=h,
                                     epilogue=epilogue, y_scale=y_scale,
                                     out_scale=out_scale)
    return y.reshape(x.shape[:-1] + y.shape[-1:])


spinner_project.plain_calls = 0


def _groups(x: torch.Tensor, grouped: bool) -> torch.Tensor:
    """x (G, ..., n) with ``grouped``, else (..., n) -> (G, rows, n)."""
    n = x.shape[-1]
    return x.reshape(x.shape[0], -1, n) if grouped else x.reshape(1, -1, n)


def spinner_project_seeded(kind: str, seeds: Union[int, torch.Tensor],
                           x: torch.Tensor, m: int, *, r: int = 1,
                           ldr_nnz: int = 4, use_hd: bool = True,
                           epilogue: str = "identity", y_scale: float = 1.0,
                           out_scale: float = 1.0, grouped: bool = False
                           ) -> torch.Tensor:
    """Zero-storage  f(y_scale · A · D1 H D0 · x) · out_scale  with the
    generator and both HD diagonals regenerated from ``seeds`` (words in
    int64, ``kernels.seedgen``): one seed, or (G,) with ``grouped=True``
    and x (G, ..., n). Output (..., m), or (..., 2m) = [cos | sin] for
    cos_sin. Same routing as :func:`spinner_project`; equal to it on
    ``seedgen.seeded_params`` (bit for bit when both run on one device).
    """
    n = x.shape[-1]
    xf = _groups(x, grouped)
    sd = torch.as_tensor(seeds, dtype=torch.int64,
                         device=x.device).reshape(xf.shape[0])
    if x.is_cuda and kernel_takes(kind, n, m, use_hd):
        y = _spin.spinner_project_seeded_cuda(
            kind, sd.contiguous(), xf.contiguous(), m, use_hd=use_hd,
            epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
    else:
        if x.is_cuda:
            spinner_project_seeded.plain_calls += 1
        y = _ref.spinner_project_seeded_ref(
            kind, sd, xf, m, r=r, ldr_nnz=ldr_nnz, use_hd=use_hd,
            epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
    return y.reshape(x.shape[:-1] + y.shape[-1:])


spinner_project_seeded.plain_calls = 0
