"""Composable Spinner embedding API: multi-block pipelines.

Port of ``repro.core.spinner``. The paper's P-model ``(A, f)`` is one
structured spinner block ``A . D1 H D0`` followed by a pointwise
nonlinearity ``f``:

* ``SpinnerBlock``    — one structured matrix kind + optional HD
                        preconditioning + fixed output scaling (n -> m).
* ``SpinnerPipeline`` — an ordered chain of blocks plus ONE fused
                        nonlinearity:  f(A_k ... A_2 A_1 x).

Both are frozen dataclasses (specs, not containers of tensors); params
are a tuple of per-block dicts of tensors. Protocol of every block and
pipeline:

    init(gen, dtype, device) -> params   sample the budget of randomness
    apply(params, x, ...)                the fast (fused) forward map
    materialize(params)                  dense oracle of the linear map
    budget / storage / flops             the paper's complexity accounting

The six built-in kinds carry ``fused=True`` and run as ONE
``kernels.ops.spinner_project`` call per block (the CUDA spinner kernel
on the card). Custom kinds registered with ``register_kind`` take a
generic path (HD -> registry matvec -> epilogue).

``to_config`` / ``from_config`` / ``dumps`` / ``loads`` read and write
the same JSON as ``repro.core.spinner``. A ``seeded=True`` block is the
zero-storage mode: its params are one seed, and every entry is
regenerated where it is used (``kernels.seedgen``; the seeded CUDA
spinner kernel on the card).
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from . import structured, transforms

# ---------------------------------------------------------------------------
# kind registry — structured matrix classes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KindDef:
    """One structured matrix class: samplers, fast/oracle paths, accounting.

    ``init(gen, m, n, r, ldr_nnz, dtype, device) -> params dict``
    ``matvec(params, x, m) -> y``            fast path, last-axis (..., n)
    ``materialize(params, m, n) -> (m, n)``  dense oracle
    ``budget/storage/flops (m, n, r) -> number``
    ``fused``: the kind is understood by kernels.ops.spinner_project.
    """
    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    matvec: Callable[..., torch.Tensor]
    materialize: Callable[..., torch.Tensor]
    budget: Callable[[int, int, int], int]
    storage: Callable[[int, int, int], int]
    flops: Callable[[int, int, int], float]
    fused: bool = False


_KINDS: Dict[str, KindDef] = {}


def register_kind(kd: KindDef, overwrite: bool = False) -> KindDef:
    if kd.name in _KINDS and not overwrite:
        raise ValueError(f"kind {kd.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _KINDS[kd.name] = kd
    return kd


def kind_def(name: str) -> KindDef:
    try:
        return _KINDS[name]
    except KeyError:
        raise ValueError(f"unknown spinner kind {name!r}; registered: "
                         f"{sorted(_KINDS)}") from None


def registered_kinds() -> Tuple[str, ...]:
    return tuple(_KINDS)


def _register_builtin(kind: str) -> None:
    register_kind(KindDef(
        name=kind,
        init=lambda gen, m, n, r=1, ldr_nnz=4, dtype=torch.float32,
        device=None, _k=kind: structured.init(
            gen, _k, m, n, r, ldr_nnz, dtype,
            gen.device if device is None else device),
        matvec=lambda params, x, m, _k=kind: structured.matvec(_k, params, x,
                                                               m),
        materialize=lambda params, m, n, _k=kind:
            structured.materialize(_k, params, m, n),
        budget=lambda m, n, r, _k=kind: structured.budget(_k, m, n, r),
        storage=lambda m, n, r, _k=kind: structured.storage_floats(_k, m, n,
                                                                   r),
        flops=lambda m, n, r, _k=kind: structured.flops_fast(_k, m, n, r),
        fused=True))


for _k in structured.KINDS:
    _register_builtin(_k)


# ---------------------------------------------------------------------------
# nonlinearity registry — the pointwise f of the pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Nonlinearity:
    """Pointwise f applied to the final projection.

    ``fn(y, sq) -> out``: ``sq`` is 0.5||x_in||^2 per row (keepdim) when
    ``needs_input`` else None. ``out_mult``: output dim multiplier (2 for
    cos_sin). ``epilogue``: fused kernel epilogue name, or None (f then
    runs after the last block). ``needs_input`` (exp) fuses in-kernel only
    for 1-block pipelines, whose kernel input IS the pipeline input.
    """
    name: str
    fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    out_mult: int = 1
    epilogue: Optional[str] = None
    needs_input: bool = False


_NONLINEARITIES: Dict[str, Nonlinearity] = {}


def register_nonlinearity(nl: Nonlinearity, overwrite: bool = False
                          ) -> Nonlinearity:
    if nl.name in _NONLINEARITIES and not overwrite:
        raise ValueError(f"nonlinearity {nl.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _NONLINEARITIES[nl.name] = nl
    return nl


def nonlinearity(name: str) -> Nonlinearity:
    try:
        return _NONLINEARITIES[name]
    except KeyError:
        raise ValueError(f"unknown nonlinearity {name!r}; registered: "
                         f"{sorted(_NONLINEARITIES)}") from None


def registered_nonlinearities() -> Tuple[str, ...]:
    return tuple(_NONLINEARITIES)


def _f_exp(y: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    return torch.exp(y.float() - sq).to(y.dtype)


register_nonlinearity(Nonlinearity(
    "identity", lambda y, sq: y, epilogue="identity"))
register_nonlinearity(Nonlinearity(
    "relu", lambda y, sq: torch.relu(y), epilogue="relu"))
register_nonlinearity(Nonlinearity(
    "heaviside", lambda y, sq: (y >= 0).to(y.dtype), epilogue="heaviside"))
register_nonlinearity(Nonlinearity(
    "sign", lambda y, sq: torch.sign(y), epilogue="sign"))
register_nonlinearity(Nonlinearity(
    "exp", _f_exp, epilogue="exp", needs_input=True))
register_nonlinearity(Nonlinearity(
    "cos_sin", lambda y, sq: torch.cat([torch.cos(y), torch.sin(y)], -1),
    out_mult=2, epilogue="cos_sin"))


# ---------------------------------------------------------------------------
# SpinnerBlock — one  A . D1 H D0  unit
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpinnerBlock:
    """One structured spinner unit: (n -> m) via  scale . A . [D1 H D0].

    ``scale`` is a fixed output scaling folded into the block's fused
    call (intermediate blocks of a stack use 1/sqrt(n) to stay
    variance-preserving).

    ``seeded=True`` is the zero-storage mode: ``init`` draws ONE seed (an
    int64 tensor holding a uint32 value) instead of tensors, and every
    entry of the generator and both HD diagonals is regenerated at its
    position inside the kernel. ``materialize`` and the diagnostics
    rebuild the params for the moment they need them. Builtin kinds only.
    """
    kind: str = "circulant"
    m: int = 128
    n: int = 128
    r: int = 1                    # displacement rank (ldr only)
    use_hd: bool = True           # paper Step-1 preconditioner
    ldr_nnz: int = 4
    scale: float = 1.0            # fixed output scaling (fused)
    seeded: bool = False          # zero-storage: params are one seed

    def __post_init__(self):
        kind_def(self.kind)
        if self.m <= 0 or self.n <= 0:
            raise ValueError(f"block dims must be positive, got "
                             f"m={self.m}, n={self.n}")
        if self.use_hd and not transforms.is_pow2(self.n):
            raise ValueError(f"use_hd requires power-of-two n, got {self.n}")
        if self.seeded and self.kind not in structured.KINDS:
            raise ValueError(
                f"seeded mode regenerates params positionally and only "
                f"supports builtin kinds {structured.KINDS}, got "
                f"{self.kind!r}")

    # --- accounting ---------------------------------------------------------

    @property
    def budget(self) -> int:
        return int(kind_def(self.kind).budget(self.m, self.n, self.r))

    @property
    def storage(self) -> int:
        if self.seeded:           # one seed regenerates everything
            return 1
        base = int(kind_def(self.kind).storage(self.m, self.n, self.r))
        return base + (2 * self.n if self.use_hd else 0)

    @property
    def flops(self) -> float:
        f = float(kind_def(self.kind).flops(self.m, self.n, self.r))
        if self.use_hd:
            f += 2.0 * self.n * math.log2(max(self.n, 2))
        return f

    # --- protocol -----------------------------------------------------------

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        """Params drawn from ``gen``, on ``device`` (by default the
        generator's own device). Seeded blocks draw one seed in
        [0, 2**31 - 1), as the reference does; ``dtype`` then only
        governs activations (generation is always f32)."""
        device = gen.device if device is None else device
        if self.seeded:
            seed = torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                 dtype=torch.int64, device=gen.device)
            return {"seed": seed.to(device)}
        params = kind_def(self.kind).init(gen, self.m, self.n, self.r,
                                          self.ldr_nnz, dtype, device)
        if self.use_hd:
            params["d0"] = transforms.sample_signs(gen, self.n, dtype, device)
            params["d1"] = transforms.sample_signs(gen, self.n, dtype, device)
        return params

    def _oracle_params(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Seeded blocks: the materialized twin of the seed (transient,
        ``structured.init`` shapes). Materialized blocks: passthrough."""
        if not self.seeded:
            return params
        from repro_torch.kernels import seedgen   # kernels import core
        return seedgen.seeded_params(self.kind, self.n, self.m,
                                     params["seed"], r=self.r,
                                     ldr_nnz=self.ldr_nnz,
                                     use_hd=self.use_hd)

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              epilogue: str = "identity", y_scale: float = 1.0,
              out_scale: float = 1.0, grouped: bool = False) -> torch.Tensor:
        """(..., n) -> (..., m):  epi(y_scale . A D1 H D0 x) . out_scale."""
        if x.shape[-1] != self.n:
            raise ValueError(f"expected last dim {self.n}, got "
                             f"{tuple(x.shape)}")
        y_scale = float(self.scale) * y_scale
        if self.seeded:
            from repro_torch.kernels import ops as kops   # kernels import core
            return kops.spinner_project_seeded(
                self.kind, params["seed"], x, self.m, r=self.r,
                ldr_nnz=self.ldr_nnz, use_hd=self.use_hd, epilogue=epilogue,
                y_scale=y_scale, out_scale=out_scale, grouped=grouped)
        if kind_def(self.kind).fused:
            from repro_torch.kernels import ops as kops   # kernels import core
            return kops.spinner_project(self.kind, params, x, self.m,
                                        epilogue=epilogue, y_scale=y_scale,
                                        out_scale=out_scale, grouped=grouped)
        return self._apply_generic(params, x, epilogue, y_scale, out_scale,
                                   grouped)

    def _apply_generic(self, params, x, epilogue, y_scale, out_scale,
                       grouped) -> torch.Tensor:
        """Registry path for custom kinds: HD -> matvec -> epilogue."""
        from repro_torch.kernels import ref as kref   # epilogue semantics
        kd = kind_def(self.kind)

        def one(p, xx):
            v = xx
            if "d0" in p:
                v = transforms.hd_preprocess(xx, p["d0"], p["d1"],
                                             use_kron=True)
            y = kd.matvec(p, v, self.m)
            if y_scale != 1.0:
                y = y * y_scale
            return kref._spinner_epilogue(y, xx, epilogue, out_scale)

        if grouped:
            return torch.stack([one({k: t[i] for k, t in params.items()},
                                    x[i]) for i in range(x.shape[0])])
        return one(params, x)

    def materialize(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dense (m, n) matrix of the whole block scale . A . [D1 H D0].
        Seeded blocks regenerate the params on demand."""
        params = self._oracle_params(params)
        a = kind_def(self.kind).materialize(params, self.m, self.n)
        if self.use_hd:
            h = transforms.hadamard(self.n, a.dtype, device=a.device)
            a = (a * params["d1"][None, :]) @ h * params["d0"][None, :]
        if self.scale != 1.0:
            a = a * self.scale
        return a

    def row_gaussianity_moments(self, params
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row mean/var of A (each row ~ N(0, I) by Def. 1)."""
        params = self._oracle_params(params)
        a = kind_def(self.kind).materialize(params, self.m, self.n)
        return a.mean(dim=1), a.var(dim=1, unbiased=False)


# ---------------------------------------------------------------------------
# SpinnerPipeline — ordered blocks + one fused nonlinearity
# ---------------------------------------------------------------------------

Params = Tuple[Dict[str, torch.Tensor], ...]


@dataclass(frozen=True)
class SpinnerPipeline:
    """f(A_k ... A_2 A_1 x): a chain of spinner blocks + pointwise f,
    fused into the last block's kernel call when the registry maps f onto
    a kernel epilogue."""
    blocks: Tuple[SpinnerBlock, ...] = (SpinnerBlock(),)
    f: str = "identity"

    def __post_init__(self):
        if isinstance(self.blocks, list):
            object.__setattr__(self, "blocks", tuple(self.blocks))
        if not self.blocks:
            raise ValueError("pipeline needs at least one block")
        for a, b in zip(self.blocks, self.blocks[1:]):
            if b.n != a.m:
                raise ValueError(
                    f"block chain mismatch: block out dim {a.m} feeds "
                    f"block in dim {b.n}")
        nonlinearity(self.f)

    # --- shape / accounting -------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.blocks)

    @property
    def n_in(self) -> int:
        return self.blocks[0].n

    @property
    def m_out(self) -> int:
        return self.blocks[-1].m

    @property
    def out_dim(self) -> int:
        return self.m_out * nonlinearity(self.f).out_mult

    @property
    def budget(self) -> int:
        return sum(b.budget for b in self.blocks)

    @property
    def storage(self) -> int:
        return sum(b.storage for b in self.blocks)

    @property
    def flops(self) -> float:
        return sum(b.flops for b in self.blocks)

    def with_f(self, f: str) -> "SpinnerPipeline":
        """Same blocks, different fused nonlinearity."""
        return self if f == self.f else replace(self, f=f)

    # --- protocol -----------------------------------------------------------

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Params:
        """Tuple of per-block param dicts, drawn from ``gen`` in order, on
        ``device`` (by default the generator's own device)."""
        device = gen.device if device is None else device
        return tuple(b.init(gen, dtype, device) for b in self.blocks)

    def block_params(self, params) -> Params:
        """Validated per-block params tuple (a bare dict is accepted for
        1-block pipelines)."""
        if isinstance(params, dict):
            if len(self.blocks) != 1:
                raise ValueError(
                    f"{len(self.blocks)}-block pipeline got a single param "
                    "dict; pass the per-block tuple from pipeline.init")
            return (params,)
        params = tuple(params)
        if len(params) != len(self.blocks):
            raise ValueError(f"expected {len(self.blocks)} per-block param "
                             f"dicts, got {len(params)}")
        return params

    def apply(self, params: Sequence[Dict[str, torch.Tensor]],
              x: torch.Tensor, *, y_scale: float = 1.0,
              out_scale: float = 1.0, grouped: bool = False) -> torch.Tensor:
        """(..., n_in) -> (..., out_dim): f(y_scale . A_k...A_1 x) . out_scale.

        ``grouped=True``: x is (G, ..., n_in) and every param leaf carries
        a leading group axis G. One spinner_project call per block; f and
        both scales fuse into the LAST block's call whenever the registry
        maps f onto a kernel epilogue.
        """
        params = self.block_params(params)
        nl = nonlinearity(self.f)
        fuse = nl.epilogue is not None and \
            (len(self.blocks) == 1 or not nl.needs_input)
        x0 = x
        for i, (blk, p) in enumerate(zip(self.blocks, params)):
            if i < len(self.blocks) - 1:
                x = blk.apply(p, x, grouped=grouped)
            elif fuse:
                x = blk.apply(p, x, epilogue=nl.epilogue, y_scale=y_scale,
                              out_scale=out_scale, grouped=grouped)
            else:
                y = blk.apply(p, x, y_scale=y_scale, grouped=grouped)
                if nl.epilogue is not None:
                    from repro_torch.kernels import ref as kref
                    x = kref._spinner_epilogue(y, x0, nl.epilogue, out_scale)
                else:
                    sq = None
                    if nl.needs_input:
                        xf = x0.float()
                        sq = 0.5 * torch.sum(xf * xf, dim=-1, keepdim=True)
                    y = nl.fn(y, sq)
                    x = y if out_scale == 1.0 else y * out_scale
        return x

    def materialize(self, params: Sequence[Dict[str, torch.Tensor]]
                    ) -> torch.Tensor:
        """Dense (m_out, n_in) product A_k ... A_1 (f not applied)."""
        params = self.block_params(params)
        a = self.blocks[0].materialize(params[0])
        for blk, p in zip(self.blocks[1:], params[1:]):
            a = blk.materialize(p) @ a
        return a

    def row_gaussianity_moments(self, params):
        """PER-BLOCK (mean, var) row diagnostics."""
        params = self.block_params(params)
        return tuple(b.row_gaussianity_moments(p)
                     for b, p in zip(self.blocks, params))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def single(kind: str = "circulant", m: int = 128, n: int = 128, *,
           r: int = 1, use_hd: bool = True, ldr_nnz: int = 4,
           f: str = "identity", seeded: bool = False) -> SpinnerPipeline:
    """The paper's P-model: one structured block + f."""
    return SpinnerPipeline(
        (SpinnerBlock(kind, m, n, r, use_hd, ldr_nnz, seeded=seeded),), f)


def chain(blocks: Sequence[SpinnerBlock], f: str = "identity"
          ) -> SpinnerPipeline:
    return SpinnerPipeline(tuple(blocks), f)


def hd_chain(kind: str = "circulant", n: int = 128, m: int = 128,
             depth: int = 3, *, r: int = 1, ldr_nnz: int = 4,
             use_hd: bool = True, f: str = "identity",
             seeded: bool = False) -> SpinnerPipeline:
    """Stacked construction HD_k ... HD_1 (TripleSpin at depth 3): depth-1
    square 1/sqrt(n)-scaled (n -> n) blocks, then one (n -> m) block."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    inv = 1.0 / math.sqrt(n)
    sq = tuple(SpinnerBlock(kind, n, n, r, use_hd, ldr_nnz, scale=inv,
                            seeded=seeded)
               for _ in range(depth - 1))
    return SpinnerPipeline(
        sq + (SpinnerBlock(kind, m, n, r, use_hd, ldr_nnz, seeded=seeded),),
        f)


# ---------------------------------------------------------------------------
# (de)serialization — the same JSON as repro.core.spinner
# ---------------------------------------------------------------------------

_CONFIG_VERSION = 1


def to_config(pipe: SpinnerPipeline) -> Dict[str, Any]:
    return {"version": _CONFIG_VERSION, "f": pipe.f,
            "blocks": [asdict(b) for b in pipe.blocks]}


def from_config(cfg: Dict[str, Any]) -> SpinnerPipeline:
    if cfg.get("version") != _CONFIG_VERSION:
        raise ValueError(f"unsupported pipeline config version: "
                         f"{cfg.get('version')!r}")
    return SpinnerPipeline(tuple(SpinnerBlock(**b) for b in cfg["blocks"]),
                           cfg["f"])


def dumps(pipe: SpinnerPipeline) -> str:
    return json.dumps(to_config(pipe), sort_keys=True)


def loads(s: str) -> SpinnerPipeline:
    return from_config(json.loads(s))
