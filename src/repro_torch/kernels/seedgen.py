"""Counter-based Gaussian regeneration for the seeded spinner, and the
stateless sampling keys of the serving engine.

Port of ``repro.kernels.seedgen``. One 32-bit seed stands for a whole
spinner block: every entry of the generator ``g`` and both HD diagonals
is regenerated at its FLAT POSITION in the canonical
``structured.init`` param array,

    value(seed, domain, p) = BoxMuller(threefry2x32((seed, domain), (p, 0)))

so any tiling (the CUDA kernel's shared-memory windows, this module's
whole-array evaluation) gives the same values.

Representation: torch on the CPU has no uint32 ``+``, ``<<`` or ``>>``,
so every 32-bit word here is an int64 tensor holding a value in
[0, 2**32), and each step of the cipher is done in int64 and masked to
32 bits. Seeds live in the port as such int64 tensors (the reference
keeps uint32). The Box–Muller step takes the f32 uniforms and the f32
angle 2π·u2 as the reference does; its ``log``, ``sqrt`` and ``cos``
run in f32 on the card, where the CUDA kernel computes the same
operations (the two agree bit for bit), and on the CPU in f64 through
numpy, rounded once to f32. Not torch's CPU ``log`` and ``cos``: their
intra-op threads split a large tensor into chunks, and on a process's
first call one chunk can come out of a less accurate path (errors up to
5e-5, seen in one of 80 fresh processes on a loaded machine). Normals
agree with the reference within 2e-6, the integer streams bit for bit.

The second half of the module rebuilds what ``jax.random`` does for the
reference's ``sampler.sample_stateless`` (jax 0.9.0, with
``jax_threefry_partitionable`` on and 64-bit mode off): raw keys,
``fold_in``, 32-bit random bits over a (hi, lo) counter iota, and the
``gumbel`` draw ``-log(-log(u))`` with u in [tiny, 1).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

# Domain separation constants (the second threefry key word).
DOM_G = 0       # generator core g
DOM_D0 = 1      # HD input Rademacher diagonal
DOM_D1 = 2      # HD output Rademacher diagonal
DOM_H_IDX = 3   # ldr h-vector support draw (uniform keys, top-nnz)
DOM_H_SGN = 4   # ldr h-vector signs
DOM_FOLD = 7    # fold_seed sub-stream derivation

MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

Words = Union[int, torch.Tensor]


def words(x: Words, device=None) -> torch.Tensor:
    """An int64 tensor of 32-bit words (values taken modulo 2**32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k0: Words, k1: Words, c0: Words, c1: Words
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standard 20-round threefry-2x32 block cipher, elementwise over
    broadcastable words: key (k0, k1), counter (c0, c1) -> two
    independent streams of int64 words."""
    dev = next((t.device for t in (c0, c1, k0, k1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1 = words(k0, dev), words(k1, dev)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (words(c0, dev) + k0) & MASK
    x1 = (words(c1, dev) + k1) & MASK
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _bits2(seed: Words, domain: int, pos: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two word streams at flat positions ``pos`` of (seed, domain)."""
    return threefry2x32(seed, domain, pos, torch.zeros_like(pos))


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """Words -> f32 uniform in [0, 1): mantissa fill, then subtract 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def normal_at(seed: Words, domain: int, pos: torch.Tensor) -> torch.Tensor:
    """f32 standard normals at flat positions ``pos`` (any shape), via
    Box–Muller over the position's two counter streams."""
    b0, b1 = _bits2(seed, domain, pos)
    u1 = 1.0 - _u01(b0)                              # (0, 1]: log-safe
    angle = torch.tensor(2.0 * math.pi, dtype=torch.float32) * _u01(b1)
    if u1.is_cuda:
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(angle)
    u1, angle = u1.numpy().astype(np.float64), angle.numpy()
    out = np.sqrt(-2.0 * np.log(u1)) * np.cos(angle.astype(np.float64))
    return torch.from_numpy(out.astype(np.float32))


def sign_at(seed: Words, domain: int, pos: torch.Tensor) -> torch.Tensor:
    """f32 Rademacher (+/-1) draws at flat positions ``pos``."""
    b0, _ = _bits2(seed, domain, pos)
    one = torch.ones((), dtype=torch.float32, device=b0.device)
    return torch.where((b0 >> 31) > 0, one, -one)


def uniform_bits_at(seed: Words, domain: int, pos: torch.Tensor
                    ) -> torch.Tensor:
    """Raw word stream at flat positions ``pos`` (ldr support draw)."""
    b0, _ = _bits2(seed, domain, pos)
    return b0


def fold_seed(seed: Words, data: Words) -> torch.Tensor:
    """Derive a sub-seed keyed by ``data`` (per-head index, per-request
    embed seed, ...). Broadcasting applies: fold_seed((H, 1), (1, B)) ->
    (H, B)."""
    dev = next((t.device for t in (seed, data)
                if isinstance(t, torch.Tensor)), None)
    d = words(data, dev)
    x0, _ = threefry2x32(seed, DOM_FOLD, d, torch.zeros_like(d))
    return x0


# ---------------------------------------------------------------------------
# tile regeneration (the index rules the CUDA kernel reads its windows by)
# ---------------------------------------------------------------------------

def gen_tile(kind: str, seed: Words, rows: torch.Tensor, cols: torch.Tensor,
             *, n: int, m: int, nb: int) -> torch.Tensor:
    """The (tm, n) row tile A[rows, cols] straight from the seed: every
    entry generated at its flat position in the canonical
    ``structured.init`` param array, so values match ``seeded_params``."""
    if kind in ("circulant", "skew_circulant"):
        blk = torch.clamp(rows // n, max=nb - 1)
        off = rows % n
        pos = blk * n + (cols - off) % n             # flat into (nb, n) g
        val = normal_at(seed, DOM_G, pos)
        if kind == "skew_circulant":
            val = torch.where(cols < off, -val, val)  # wrapped entries negated
        return val
    if kind == "toeplitz":
        d = torch.clamp(cols - rows, -(m - 1), n - 1)
        pos = torch.where(d >= 0, d, n - 1 - d)      # structured._toeplitz_dense
        return normal_at(seed, DOM_G, pos)
    if kind == "hankel":
        pos = torch.clamp(rows + cols, 0, n + m - 2)
        return normal_at(seed, DOM_G, pos)
    if kind == "unstructured":
        pos = torch.clamp(rows, max=m - 1) * n + cols  # flat into (m, n) g
        return normal_at(seed, DOM_G, pos)
    raise ValueError(kind)


def hd_signs(seed: Words, n: int, device=None) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(d0, d1) f32 Rademacher diagonals of the HD preconditioner."""
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    pos = torch.arange(n, dtype=torch.int64, device=device)
    return sign_at(seed, DOM_D0, pos), sign_at(seed, DOM_D1, pos)


# ---------------------------------------------------------------------------
# generator oracle: rebuild the structured.init param dict from seeds
# ---------------------------------------------------------------------------

def _params(kind: str, n: int, m: int, seed: torch.Tensor, lead, r: int,
            ldr_nnz: int, use_hd: bool) -> Dict[str, torch.Tensor]:
    """Params for a seed tensor of shape ``lead + (1,)``: every leaf gets
    the leading ``lead`` axes."""
    from repro_torch.core import structured      # deferred: core imports kernels
    dev = seed.device
    b = structured.n_blocks(kind, m, n)

    def at(fn, domain, count, shape):
        pos = torch.arange(count, dtype=torch.int64, device=dev)
        return fn(seed, domain, pos).reshape(*lead, *shape)

    if kind == "unstructured":
        params = {"g": at(normal_at, DOM_G, m * n, (m, n))}
    elif kind in ("circulant", "skew_circulant"):
        params = {"g": at(normal_at, DOM_G, b * n, (b, n))}
    elif kind in ("toeplitz", "hankel"):
        params = {"g": at(normal_at, DOM_G, n + m - 1, (n + m - 1,))}
    elif kind == "ldr":
        g = at(normal_at, DOM_G, b * r * n, (b, r, n))
        # h support: the ldr_nnz smallest uniform keys per (block, rank)
        # row (a deterministic draw without replacement); signs from an
        # independent stream, magnitude 1/sqrt(nnz * r) as in the paper.
        keys = at(uniform_bits_at, DOM_H_IDX, b * r * n, (b, r, n))
        rank = torch.argsort(torch.argsort(keys, dim=-1, stable=True),
                             dim=-1, stable=True)
        sgn = at(sign_at, DOM_H_SGN, b * r * n, (b, r, n))
        val = sgn * torch.tensor(1.0 / math.sqrt(ldr_nnz * r),
                                 dtype=torch.float32)
        params = {"g": g, "h": torch.where(rank < ldr_nnz, val,
                                           torch.zeros_like(val))}
    else:
        raise ValueError(f"unknown structured kind: {kind}")
    if use_hd:
        params["d0"] = at(sign_at, DOM_D0, n, (n,))
        params["d1"] = at(sign_at, DOM_D1, n, (n,))
    return params


def seeded_params(kind: str, n: int, m: int, seed: Words, *, r: int = 1,
                  ldr_nnz: int = 4, use_hd: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """The materialized twin of one seed: the exact f32 param dict
    (``structured.init`` shapes) the seed encodes, on the seed's device."""
    s = words(seed).reshape(1)
    return _params(kind, n, m, s, (), r, ldr_nnz, use_hd)


def grouped_params(kind: str, n: int, m: int, seeds: torch.Tensor, *,
                   r: int = 1, ldr_nnz: int = 4, use_hd: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """``seeded_params`` over a (G,) seed vector in one batched
    evaluation: every leaf gains the leading group axis G."""
    s = words(seeds).reshape(-1, 1)
    return _params(kind, n, m, s, (s.shape[0],), r, ldr_nnz, use_hd)


# ---------------------------------------------------------------------------
# jax.random's threefry key functions (the sampler's noise)
# ---------------------------------------------------------------------------

def threefry_seed(seed: int, device=None) -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)`` with 64-bit mode off:
    (0, seed mod 2**32), as a (2,) tensor of words."""
    return torch.stack([words(0, device), words(seed, device)])


def fold_in(key: torch.Tensor, data: Words) -> torch.Tensor:
    """``jax.random.fold_in`` over keys (..., 2) and data (...) words ->
    keys (..., 2): the cipher of the counter (0, data) under the key."""
    d = words(data, key.device)
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, v: int) -> torch.Tensor:
    """32-bit random bits of shape (..., v) for keys (..., 2): jax's
    partitionable form, counters (hi, lo) = (0, iota) and bits1 ^ bits2."""
    lo = torch.arange(v, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(keys: torch.Tensor, v: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (v,), float32)`` for every key of a
    (..., 2) stack: -log(-log(u)), u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = _u01(random_bits(keys, v))
    u = torch.clamp(u * (1.0 - tiny) + tiny, min=tiny)
    return -torch.log(-torch.log(u))
