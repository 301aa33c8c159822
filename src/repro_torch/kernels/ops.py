"""Dispatchers between the CUDA kernels and their plain PyTorch versions.

Counterpart of ``repro.kernels.ops`` for the two kernels of the SRF
serving slice. Routing follows where the tensor lies:

* a CUDA tensor goes to the kernel, or raises if the kernel refuses it —
  there is no fallback that hides a kernel failure;
* a CPU tensor goes to the plain version in ``kernels.ref``;
* what the spinner kernel does not take (kind ``ldr``, HD with a
  non-power-of-two n, n > 8192 — the reference's ``pallas_ok`` rule)
  goes to the plain version on either device, and on the card such a
  call is counted in ``spinner_project.plain_calls``.

There is no interpret route and no block-size plan cache: block sizes
are the kernels' own. Launch counts live on the kernel wrappers
(``spinner.spinner_project_cuda.launches``,
``srf_decode.srf_decode_cuda.launches``); :func:`launch_counts` reads
them and :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import transforms

from . import ref as _ref
from . import spinner as _spin
from . import srf_decode as _dec


def launch_counts() -> Dict[str, int]:
    return {"spinner": _spin.spinner_project_cuda.launches,
            "srf_decode": _dec.srf_decode_cuda.launches,
            "spinner_plain_on_cuda": spinner_project.plain_calls}


def reset_counts() -> None:
    _spin.spinner_project_cuda.launches = 0
    _dec.srf_decode_cuda.launches = 0
    spinner_project.plain_calls = 0


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
    if grouped:
        gsz, lead = x.shape[0], tuple(x.shape[1:-1])
        xf = x.reshape(gsz, -1, n)
    else:
        gsz, lead = 1, tuple(x.shape[:-1])
        xf = x.reshape(1, -1, n)
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
    out_dim = 2 * m if epilogue == "cos_sin" else m
    shape = ((gsz,) + lead + (out_dim,)) if grouped else (lead + (out_dim,))
    return y.reshape(shape)


spinner_project.plain_calls = 0
