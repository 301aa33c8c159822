"""The index rules of ``csrc/window_mma.cuh``, the tensor-core mainloop
that ``csrc/circulant.cu`` and ``csrc/spinner.cu`` share, stated in plain
PyTorch so that the CPU tests can hold them to the dense matrices.

A block owns ``BN`` output columns i0 .. i0 + BN - 1 and multiplies in
chunks of ``BK`` input columns. For chunk j0 its B operand is the
(BK, BN) tile ``[k, c] = A[i0 + c, j0 + k]``, read from one of three
layouts (:func:`layout`):

* ``"window"``: a Toeplitz window w, ``[k, c] = w[j0 + k - c + BN - 1]``
  (circulant and skew-circulant tiles inside one generator block, every
  Toeplitz tile);
* ``"hankel"``: a Hankel window, ``[k, c] = w[j0 + k + c]``;
* ``"built"``: the tile written each chunk by the per-row rule (circulant
  and skew tiles that cross a generator block or n < BN, dense A).

The window holds the ``window_len(n)`` values the block's columns read
over all chunks, written once a block. A source gives the generator's
values: ``at(p)`` the value at flat position p of the canonical generator
array, ``toeplitz(k)`` the value of glin[k] (glin = [flip(g[n:]),
g[:n]]). The materialized kernel reads g itself; the seeded kernel draws
the values of :func:`seeded_positions` once and reads them from shared
memory.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

BN, BK = 128, 32        # output columns a block, input columns a chunk
RES_N = 128             # n up to which a spinner block keeps its rows
#                         resident (no pre-pass)
# the epilogue numbering of the header (circulant takes all but sign)
EPILOGUES = ("identity", "relu", "heaviside", "sign", "exp", "cos_sin")

Source = Tuple[Callable[[torch.Tensor], torch.Tensor],
               Callable[[torch.Tensor], torch.Tensor]]


def window_len(n: int) -> int:
    """Values of a block's window: every chunk's BN + BK - 1, overlapping."""
    return -(-n // BK) * BK + BN


def crosses_block(n: int, m: int) -> bool:
    """Whether some column tile of a circulant / skew A crosses a
    generator block (then the launch reserves a built tile)."""
    return n < BN or (n % BN != 0 and m > (n // BN) * BN)


def layout(kind: str, n: int, i0: int) -> str:
    """Which operand layout the block of columns i0 reads."""
    if kind == "hankel":
        return "hankel"
    if kind == "toeplitz":
        return "window"
    if kind == "unstructured":
        return "built"
    return "window" if i0 % n + BN <= n else "built"


def dense_source(g: torch.Tensor, n: int, m: int) -> Source:
    """The materialized generator g of one group (any canonical shape)."""
    flat = g.reshape(-1)

    def toeplitz(k):
        return flat[torch.where(k >= m - 1, k - (m - 1), n + m - 2 - k)]
    return (lambda p: flat[p]), toeplitz


def window(kind: str, src: Source, n: int, m: int, i0: int) -> torch.Tensor:
    """w[u], u < window_len(n), of the block of columns i0 (a window
    layout): 0 where no valid (i, j) reads it (Toeplitz, Hankel), indices
    mod n otherwise."""
    at, toeplitz = src
    u = torch.arange(window_len(n))
    i_hi = min(i0 + BN, m) - 1
    zero = torch.zeros(())
    if kind == "hankel":
        p = i0 + u
        ok = p <= i_hi + n - 1
        return torch.where(ok, at(torch.where(ok, p, i0)), zero)
    if kind == "toeplitz":
        k = u - (BN - 1) - i0 + m - 1
        lo = m - 1 - i_hi
        ok = (k >= lo) & (k <= n + m - 2 - i0)
        return torch.where(ok, toeplitz(torch.where(ok, k, lo)), zero)
    gb = (i0 // n) * n
    t = u - (BN - 1) - i0 % n
    if kind == "circulant":
        return at(gb + t % n)
    d = (t + n) % (2 * n)                    # index into [-g, g]
    v = at(gb + d % n)
    return torch.where(d >= n, v, -v)


def built_tile(kind: str, src: Source, n: int, m: int, i0: int,
               j0: int) -> torch.Tensor:
    """The (BK, BN) tile by the per-row rule, zero past m and n."""
    at, toeplitz = src
    i = i0 + torch.arange(BN)[None, :]
    j = j0 + torch.arange(BK)[:, None]
    valid = (i < m) & (j < n)
    i, j = torch.where(valid, i, i0), torch.where(valid, j, 0)
    if kind == "unstructured":
        v = at(i * n + j)
    elif kind == "hankel":
        v = at(i + j)
    elif kind == "toeplitz":
        v = toeplitz(j - i + m - 1)
    else:
        d = j - i % n
        v = at((i // n) * n + d % n)
        if kind == "skew_circulant":
            v = torch.where(d < 0, -v, v)
    return torch.where(valid, v, torch.zeros(()))


def operand(kind: str, src: Source, n: int, m: int, i0: int,
            j0: int) -> torch.Tensor:
    """The (BK, BN) operand the kernel multiplies chunk j0 of columns i0
    by: [k, c] = A[i0 + c, j0 + k] wherever both are in range."""
    lay = layout(kind, n, i0)
    if lay == "built":
        return built_tile(kind, src, n, m, i0, j0)
    w = window(kind, src, n, m, i0)
    k = torch.arange(BK)[:, None]
    c = torch.arange(BN)[None, :]
    return w[j0 + k + c] if lay == "hankel" else w[j0 + k - c + BN - 1]


def seeded_positions(kind: str, n: int, m: int, i0: int
                     ) -> Tuple[int, torch.Tensor]:
    """(base, pos): the seeded block of columns i0 draws gen[u] =
    normal_at(seed, DOM_G, pos[u]), the value at flat position base + u
    (Toeplitz: glin index base + u). Dense A draws where it reads
    (no positions)."""
    i_hi = min(i0 + BN, m) - 1
    if kind in ("circulant", "skew_circulant"):
        base = (i0 // n) * n
        return base, base + torch.arange((i_hi // n - i0 // n + 1) * n)
    if kind == "toeplitz":
        base = m - 1 - i_hi
        k = base + torch.arange(i_hi - i0 + n)
        return base, torch.where(k >= m - 1, k - (m - 1), n + m - 2 - k)
    if kind == "hankel":
        return i0, i0 + torch.arange(i_hi - i0 + n)
    return 0, torch.zeros(0, dtype=torch.int64)


def seeded_source(kind: str, seed: int, n: int, m: int, i0: int) -> Source:
    """The seeded block's values: drawn once at ``seeded_positions``, or
    (dense A) at each position read."""
    from .seedgen import DOM_G, normal_at
    if kind == "unstructured":
        return (lambda p: normal_at(seed, DOM_G, p)), None
    base, pos = seeded_positions(kind, n, m, i0)
    gen = normal_at(seed, DOM_G, pos)
    return (lambda p: gen[p - base]), (lambda k: gen[k - base])
