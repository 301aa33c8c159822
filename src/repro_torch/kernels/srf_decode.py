"""Wrapper of the CUDA SRF decode kernel (``csrc/srf_decode.cu``):
S' = S + φ_kᵀv, z' = z + φ_k, out = (φ_q·S')/(φ_q·z' + eps), with S and
z updated in place.

Counterpart of ``repro.kernels.srf_decode.srf_decode_pallas``. CUDA
tensors only; ``kernels.ops.srf_decode`` routes CPU tensors to the plain
version (``kernels.ref.srf_decode_ref``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("srf_decode")
    lib.srf_decode_f32.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, _P]
    lib.srf_decode_f32.restype = ctypes.c_int
    return lib


def srf_decode_cuda(s: torch.Tensor, z: torch.Tensor, phi_q: torch.Tensor,
                    phi_k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """s: (B,H,m,dv) z: (B,H,m) phi_*: (B,H,m) v: (B,H,dv), all contiguous
    float32 on one CUDA device -> (s, z, out) with s and z updated IN
    PLACE and out (B,H,dv). ``srf_decode_cuda.launches`` counts launches."""
    if s.dim() != 4:
        raise ValueError(f"srf_decode kernel: s must be (B,H,m,dv), got "
                         f"{tuple(s.shape)}")
    b, h, m, dv = s.shape
    shapes = {"s": (s, (b, h, m, dv)), "z": (z, (b, h, m)),
              "phi_q": (phi_q, (b, h, m)), "phi_k": (phi_k, (b, h, m)),
              "v": (v, (b, h, dv))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.device != s.device:
            raise ValueError(f"srf_decode kernel needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"srf_decode kernel takes float32, got {name} "
                             f"{t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"srf_decode kernel: {name} must be a "
                             f"contiguous {shape} tensor, got "
                             f"{tuple(t.shape)}")
    out = torch.empty((b, h, dv), dtype=torch.float32, device=s.device)
    if b * h == 0:
        return s, z, out
    rc = _lib().srf_decode_f32(
        s.data_ptr(), z.data_ptr(), phi_q.data_ptr(), phi_k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b * h, m, dv, float(eps),
        torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"srf_decode kernel launch failed: cudaError {rc}")
    srf_decode_cuda.launches += 1
    return s, z, out


srf_decode_cuda.launches = 0
