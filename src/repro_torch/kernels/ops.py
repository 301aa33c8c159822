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

The two spinner ops are differentiable on the card, as the reference's
``_spinner_pallas_vjp`` and ``_spinner_seeded_vjp`` are: a
``torch.autograd.Function`` runs the CUDA kernel forward and the VJP of
the plain version backward (with respect to g, x, d0 and d1; seeded:
the params regenerated from the seeds, then x only, seeds get no
gradient). The reference has no backward kernel to port: its backward
is jnp ops outside any Pallas kernel, and this one is PyTorch ops. The
backward calls are counted apart (``spinner_project.backward_calls``,
``spinner_project_seeded.backward_calls``). The other five kernels have
no backward (nor has the reference): a call that would launch one with
an input that requires grad, while grad mode is on, raises instead of
returning a result with no ``grad_fn``. Under ``torch.no_grad()`` the
kernels run; the plain versions, on the CPU and on the card, stay
differentiable.

Every dispatcher runs its kernel or plain version through
``obs.profiling.dispatch`` under the reference's kernel name
(``spinner_project``, ``spinner_project_seeded``, ``srf_decode``,
``paged_gather``, ``paged_gather_dequant``, ``fwht``,
``circulant_project``; the port's own ``paged_gather_dequant_kv`` under
that name): with ``--kernel-timing`` each dispatch is timed into
``kernel_dispatch_seconds{kernel=...}``; otherwise the wrapper only
calls it. The grad refusals run before it, outside the timed region.

There is no interpret route and no block-size plan cache: block sizes
are the kernels' own. Launch counts live on the kernel wrappers
(``spinner.spinner_project_cuda.launches``,
``spinner.spinner_project_seeded_cuda.launches``,
``srf_decode.srf_decode_cuda.launches``,
``paged_gather.paged_gather_cuda.launches``,
``paged_gather.paged_gather_dequant_cuda.launches``,
``paged_gather.paged_gather_dequant_kv_cuda.launches``,
``fwht.fwht_cuda.launches``,
``circulant.circulant_project_cuda.launches``);
:func:`launch_counts` reads them and :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import transforms
from repro_torch.obs import profiling as _prof

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
            "paged_gather_dequant_kv":
                _pg.paged_gather_dequant_kv_cuda.launches,
            "spinner_seeded": _spin.spinner_project_seeded_cuda.launches,
            "spinner_plain_on_cuda": spinner_project.plain_calls,
            "spinner_seeded_plain_on_cuda":
                spinner_project_seeded.plain_calls,
            "spinner_bwd": spinner_project.backward_calls,
            "spinner_seeded_bwd": spinner_project_seeded.backward_calls,
            "fwht": _fwht.fwht_cuda.launches,
            "fwht_plain_on_cuda": fwht.plain_calls,
            "circulant_project": _circ.circulant_project_cuda.launches}


def reset_counts() -> None:
    _spin.spinner_project_cuda.launches = 0
    _dec.srf_decode_cuda.launches = 0
    _pg.paged_gather_cuda.launches = 0
    _pg.paged_gather_dequant_cuda.launches = 0
    _pg.paged_gather_dequant_kv_cuda.launches = 0
    _spin.spinner_project_seeded_cuda.launches = 0
    spinner_project.plain_calls = 0
    spinner_project_seeded.plain_calls = 0
    spinner_project.backward_calls = 0
    spinner_project_seeded.backward_calls = 0
    _fwht.fwht_cuda.launches = 0
    fwht.plain_calls = 0
    _circ.circulant_project_cuda.launches = 0


def _no_grad_needed(op: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if the kernel behind ``op`` would be asked for a gradient:
    grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward yet, and an input "
            f"requires grad; call it under torch.no_grad(), or on CPU "
            f"tensors for the differentiable plain version")


def fwht(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """(..., n) -> (..., n) Walsh-Hadamard transform (Sylvester order, n a
    power of two), scaled by 1/sqrt(n) when ``normalized``; f32
    arithmetic, one cast to x's dtype."""
    n = x.shape[-1]
    if not transforms.is_pow2(n):
        raise ValueError(f"fwht needs power-of-two length, got {n}")
    rows = x.reshape(-1, n)
    if x.is_cuda and n <= _fwht.MAX_N:
        _no_grad_needed("fwht", x)
        y = _prof.dispatch("fwht", lambda: _fwht.fwht_cuda(
            rows.contiguous(), normalized))
    else:
        if x.is_cuda:
            fwht.plain_calls += 1
        y = _prof.dispatch("fwht", lambda: _ref.fwht_ref(rows, normalized))
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
        _no_grad_needed("circulant_project", g, x, sq)
        return _prof.dispatch(
            "circulant_project", lambda: _circ.circulant_project_cuda(
                g.contiguous(), x.contiguous(), m, epilogue, sq))
    return _prof.dispatch("circulant_project",
                          lambda: _ref.circulant_project_ref(
                              g, x, m, epilogue, sq))


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (N, P, D), tables (R, M) -> (R, M*P, D) contiguous history."""
    if pool.is_cuda:
        _no_grad_needed("paged_gather", pool)
        return _prof.dispatch("paged_gather",
                              lambda: _pg.paged_gather_cuda(pool, tables))
    return _prof.dispatch("paged_gather",
                          lambda: _ref.paged_gather_ref(pool, tables))


def paged_gather_dequant(pool: torch.Tensor, scales: torch.Tensor,
                         tables: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """int8 pool (N, P, D) + scales (N, P, 1), tables (R, M) ->
    (R, M*P, D) dequantized history in ``out_dtype``."""
    if pool.is_cuda:
        _no_grad_needed("paged_gather_dequant", pool, scales)
        return _prof.dispatch(
            "paged_gather_dequant", lambda: _pg.paged_gather_dequant_cuda(
                pool, scales, tables, out_dtype))
    return _prof.dispatch("paged_gather_dequant",
                          lambda: _ref.paged_gather_dequant_ref(
                              pool, scales, tables, out_dtype))


def paged_gather_dequant_kv(k_pool: torch.Tensor, k_scales: torch.Tensor,
                            v_pool: torch.Tensor, v_scales: torch.Tensor,
                            tables: torch.Tensor, out_dtype=torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's K and V: :func:`paged_gather_dequant` of both int8 pools
    (one shape) through one table, as (k, v); on the card one launch."""
    if k_pool.is_cuda:
        _no_grad_needed("paged_gather_dequant_kv", k_pool, k_scales, v_pool,
                        v_scales)
        return _prof.dispatch(
            "paged_gather_dequant_kv",
            lambda: _pg.paged_gather_dequant_kv_cuda(
                k_pool, k_scales, v_pool, v_scales, tables, out_dtype))
    return _prof.dispatch("paged_gather_dequant_kv", lambda: (
        _ref.paged_gather_dequant_ref(k_pool, k_scales, tables, out_dtype),
        _ref.paged_gather_dequant_ref(v_pool, v_scales, tables, out_dtype)))


def srf_decode(s: torch.Tensor, z: torch.Tensor, phi_q: torch.Tensor,
               phi_k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s', z', out); see ``kernels.ref.srf_decode_ref`` for shapes. On
    the card s and z are updated in place (the returned s', z' are s, z);
    callers pass state they own and use the returned tensors."""
    if s.is_cuda:
        _no_grad_needed("srf_decode", s, z, phi_q, phi_k, v)
        return _prof.dispatch("srf_decode", lambda: _dec.srf_decode_cuda(
            s, z, phi_q, phi_k, v, eps))
    return _prof.dispatch("srf_decode", lambda: _ref.srf_decode_ref(
        s, z, phi_q, phi_k, v, eps))


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
        y = _prof.dispatch("spinner_project", lambda: _SpinnerKernel.apply(
            g, xf, d0, d1, kind, m, epilogue, y_scale, out_scale))
    else:
        if x.is_cuda:
            spinner_project.plain_calls += 1
        y = _prof.dispatch("spinner_project",
                           lambda: _ref.spinner_project_ref(
                               kind, g, xf, m, d0=d0, d1=d1, h=h,
                               epilogue=epilogue, y_scale=y_scale,
                               out_scale=out_scale))
    return y.reshape(x.shape[:-1] + y.shape[-1:])


spinner_project.plain_calls = 0
spinner_project.backward_calls = 0


def _vjp(fn, inputs, needs, dy):
    """The VJP of ``fn(*inputs)`` at ``dy`` for the inputs flagged in
    ``needs`` (None for the others), by autograd on fresh leaves."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        y = fn(*leaves)
        want = [t for t, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad(y, want, dy) if want else ())
    return tuple(next(got) if need else None for need in needs)


class _SpinnerKernel(torch.autograd.Function):
    """The spinner kernel forward, the plain version's VJP backward (the
    reference's ``_spinner_pallas_vjp``). g, x, d0, d1 are grouped:
    (G, ...) leaves, x (G, B, n)."""

    @staticmethod
    def forward(ctx, g, x, d0, d1, kind, m, epilogue, y_scale, out_scale):
        ctx.save_for_backward(g, x, d0, d1)
        ctx.conf = (kind, m, epilogue, y_scale, out_scale)
        return _spin.spinner_project_cuda(
            kind, g.contiguous(), x.contiguous(), m,
            d0=None if d0 is None else d0.contiguous(),
            d1=None if d1 is None else d1.contiguous(),
            epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)

    @staticmethod
    def backward(ctx, dy):
        kind, m, epilogue, y_scale, out_scale = ctx.conf
        spinner_project.backward_calls += 1

        def plain(g, x, d0, d1):
            return _ref.spinner_project_ref(kind, g, x, m, d0=d0, d1=d1,
                                            epilogue=epilogue,
                                            y_scale=y_scale,
                                            out_scale=out_scale)
        with torch.profiler.record_function("spinner_project_bwd"):
            grads = _vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:4],
                         dy)
        return grads + (None,) * 5


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
        y = _prof.dispatch(
            "spinner_project_seeded", lambda: _SeededSpinnerKernel.apply(
                sd, xf, kind, m, r, ldr_nnz, use_hd, epilogue, y_scale,
                out_scale))
    else:
        if x.is_cuda:
            spinner_project_seeded.plain_calls += 1
        y = _prof.dispatch(
            "spinner_project_seeded",
            lambda: _ref.spinner_project_seeded_ref(
                kind, sd, xf, m, r=r, ldr_nnz=ldr_nnz, use_hd=use_hd,
                epilogue=epilogue, y_scale=y_scale, out_scale=out_scale))
    return y.reshape(x.shape[:-1] + y.shape[-1:])


spinner_project_seeded.plain_calls = 0
spinner_project_seeded.backward_calls = 0


class _SeededSpinnerKernel(torch.autograd.Function):
    """The seeded spinner kernel forward; backward: regenerate the params
    from the seeds (``seedgen.grouped_params``) and take the plain
    version's VJP with respect to x only (the reference's
    ``_spinner_seeded_vjp``). The seeds are integers: no gradient."""

    @staticmethod
    def forward(ctx, seeds, x, kind, m, r, ldr_nnz, use_hd, epilogue,
                y_scale, out_scale):
        ctx.save_for_backward(seeds, x)
        ctx.conf = (kind, m, r, ldr_nnz, use_hd, epilogue, y_scale,
                    out_scale)
        return _spin.spinner_project_seeded_cuda(
            kind, seeds.contiguous(), x.contiguous(), m, use_hd=use_hd,
            epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)

    @staticmethod
    def backward(ctx, dy):
        from . import seedgen
        kind, m, r, ldr_nnz, use_hd, epilogue, y_scale, out_scale = ctx.conf
        seeds, x = ctx.saved_tensors
        spinner_project_seeded.backward_calls += 1
        with torch.profiler.record_function("spinner_project_seeded_bwd"):
            p = seedgen.grouped_params(kind, x.shape[-1], m, seeds, r=r,
                                       ldr_nnz=ldr_nnz, use_hd=use_hd)

            def plain(xx):
                return _ref.spinner_project_ref(
                    kind, p["g"], xx, m, d0=p.get("d0"), d1=p.get("d1"),
                    h=p.get("h"), epilogue=epilogue, y_scale=y_scale,
                    out_scale=out_scale)
            dx, = _vjp(plain, (x,), (ctx.needs_input_grad[1],), dy)
        return (None, dx) + (None,) * 8
