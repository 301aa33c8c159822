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

While a cost analysis is active (``launch.cost_analysis``, through
``obs.cost``), a dispatcher whose call the card's kernel would take adds
the kernel's operations and bytes by the formulas of ``kernels/cost.py``
and runs it (off the card: its plain version) unseen by the analysis,
or, on ``meta``, returns an empty output of the kernel's shape; the
spinner ops keep their autograd Functions, so the plain backward that
training runs is counted op by op.

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
from repro_torch.obs import cost as _cost
from repro_torch.obs import profiling as _prof

from . import circulant as _circ
from . import cost as _kcost
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


def _counted(name: str, cost, run, empty, inputs):
    """``run()``, or under an active cost analysis the kernel's ``cost()``
    (operations, bytes) recorded and ``run()`` unseen (``empty()`` on
    meta)."""
    a = _cost.current()
    if a is None:
        return run()
    return a.kernel(name, *cost(), run, empty, inputs)


def fwht(x: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """(..., n) -> (..., n) Walsh-Hadamard transform (Sylvester order, n a
    power of two), scaled by 1/sqrt(n) when ``normalized``; f32
    arithmetic, one cast to x's dtype."""
    n = x.shape[-1]
    if not transforms.is_pow2(n):
        raise ValueError(f"fwht needs power-of-two length, got {n}")
    rows = x.reshape(-1, n)
    if _cost.current() is not None and n <= _fwht.MAX_N:
        return _counted("fwht", lambda: _kcost.fwht(rows.shape[0], n,
                                                    x.element_size()),
                        lambda: _fwht_call(x, rows, n, normalized),
                        lambda: torch.empty_like(x), (x,))
    return _fwht_call(x, rows, n, normalized)


def _fwht_call(x, rows, n, normalized):
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
    width = 2 * m if epilogue == "cos_sin" else m
    return _counted(
        "circulant_project",
        lambda: _kcost.circulant(x.shape[0], n, nb, m, x.element_size(),
                                 width),
        lambda: _circulant_call(g, x, m, epilogue, sq),
        lambda: x.new_empty((x.shape[0], width)), (g, x))


def _circulant_call(g, x, m, epilogue, sq):
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
    _, p, d = pool.shape
    r, w = tables.shape
    return _counted("paged_gather",
                    lambda: _kcost.gather(r * w * p, d, pool.element_size()),
                    lambda: _paged_gather_call(pool, tables),
                    lambda: pool.new_empty((r, w * p, d)), (pool, tables))


def _paged_gather_call(pool, tables):
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
    _, p, d = pool.shape
    r, w = tables.shape
    return _counted(
        "paged_gather_dequant",
        lambda: _kcost.gather_dequant(r * w * p, d, out_dtype.itemsize),
        lambda: _dequant_call(pool, scales, tables, out_dtype),
        lambda: pool.new_empty((r, w * p, d), dtype=out_dtype),
        (pool, scales, tables))


def _dequant_call(pool, scales, tables, out_dtype):
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
    _, p, d = k_pool.shape
    r, w = tables.shape
    return _counted(
        "paged_gather_dequant_kv",
        lambda: _kcost.gather_dequant(r * w * p, d, out_dtype.itemsize,
                                      pools=2),
        lambda: _dequant_kv_call(k_pool, k_scales, v_pool, v_scales, tables,
                                 out_dtype),
        lambda: tuple(k_pool.new_empty((r, w * p, d), dtype=out_dtype)
                      for _ in range(2)),
        (k_pool, k_scales, v_pool, v_scales, tables))


def _dequant_kv_call(k_pool, k_scales, v_pool, v_scales, tables, out_dtype):
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
    b, h, m, dv = s.shape
    return _counted(
        "srf_decode", lambda: _kcost.srf_decode(b, h, m, dv,
                                                s.element_size()),
        lambda: _srf_decode_call(s, z, phi_q, phi_k, v, eps),
        lambda: (s, z, s.new_empty((b, h, dv))), (s, z, phi_q, phi_k, v))


def _srf_decode_call(s, z, phi_q, phi_k, v, eps):
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


H100_SM_COUNT = 132      # NVIDIA H100 SXM5: the plan's SM count off the card
PLAN_BN = 128            # csrc/spinner.cu: output columns a block


def spinner_plan(kind: str, n: int, m: int, *, use_hd: bool = True,
                 epilogue: str = "identity", dtype=torch.float32,
                 budget: Optional[int] = None, seeded: bool = False,
                 G: int = 1, B: Optional[int] = None,
                 sm_count: Optional[int] = None) -> Tuple[int, int]:
    """The spinner kernel's launch plan ``(block_b, block_m)`` = (BM, BN)
    for G groups of B rows: ``pick_mt`` of ``csrc/spinner.cu`` (BM 128
    rows where that still gives two blocks an SM, else 32; BN 128
    columns). The SM count is the card's, or ``sm_count``, or without a
    card an H100 SXM5's 132. B None plans one 128-row tile. The kind,
    HD, epilogue, dtype and seeding do not change the plan; ``budget``
    is the reference's VMEM budget, which a CUDA block does not have
    (accepted and ignored)."""
    if sm_count is None:
        sm_count = (torch.cuda.get_device_properties(0).multi_processor_count
                    if torch.cuda.is_available() else H100_SM_COUNT)
    rows = 128 if B is None else B
    tiles = G * -(-m // PLAN_BN) * -(-rows // 128)
    return (128 if tiles >= 2 * sm_count else 32), PLAN_BN


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
    on_card = x.is_cuda or _cost.current() is not None
    if on_card and kernel_takes(kind, n, m, d0 is not None):
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
        if x.is_cuda or _cost.current() is None:
            run = lambda: _spin.spinner_project_cuda(  # noqa: E731
                kind, g.contiguous(), x.contiguous(), m,
                d0=None if d0 is None else d0.contiguous(),
                d1=None if d1 is None else d1.contiguous(),
                epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
        else:                           # a cost analysis off the card
            run = lambda: _ref.spinner_project_ref(  # noqa: E731
                kind, g, x, m, d0=d0, d1=d1, epilogue=epilogue,
                y_scale=y_scale, out_scale=out_scale)
        gsz, bsz, n = x.shape
        width = 2 * m if epilogue == "cos_sin" else m
        return _counted(
            "spinner_project",
            lambda: _kcost.spinner(kind, gsz, bsz, n, m, x.element_size(),
                                   g[0].numel(), width, d0 is not None),
            run, lambda: x.new_empty((gsz, bsz, width)), (g, x))

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
    on_card = x.is_cuda or _cost.current() is not None
    if on_card and kernel_takes(kind, n, m, use_hd):
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
        if x.is_cuda or _cost.current() is None:
            run = lambda: _spin.spinner_project_seeded_cuda(  # noqa: E731
                kind, seeds.contiguous(), x.contiguous(), m, use_hd=use_hd,
                epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
        else:                           # a cost analysis off the card
            run = lambda: _ref.spinner_project_seeded_ref(  # noqa: E731
                kind, seeds, x, m, r=r, ldr_nnz=ldr_nnz, use_hd=use_hd,
                epilogue=epilogue, y_scale=y_scale, out_scale=out_scale)
        gsz, bsz, n = x.shape
        width = 2 * m if epilogue == "cos_sin" else m
        return _counted(
            "spinner_project_seeded",
            lambda: _kcost.seeded(kind, gsz, bsz, n, m, x.element_size(),
                                  width, use_hd),
            run, lambda: x.new_empty((gsz, bsz, width)), (seeds, x))

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
