"""Structured-JL gradient compression (the paper's f=identity case) for
cross-pod data parallelism, with error feedback. Port of
``repro.optim.compression``.

Gradients cross the slow pod boundary as m/n-size sketches:

    sketch      y = A x          A = circulant P-model, O(n) storage,
                                 regenerated from a shared seed on both ends
    unsketch    x' = A^T y / n   (contractive scaling; / m: unbiased)

Error feedback keeps the bias from hurting convergence: each worker
accumulates (x - unsketch(sketch(x))) locally and adds it to the next
step's gradient before sketching.

The generators are drawn as the reference draws them:
``jax.random.normal`` under the key ``fold_in(fold_in(PRNGKey(seed),
leaf index), step)``, through the port's threefry (``kernels.seedgen``:
the same bits; the normals through ``torch.erfinv``, within a few ulp of
XLA's). The reduction across pods that consumes the sketches is
``distributed.collectives.compressed_pod_mean``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import structured


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "circulant"
    ratio: int = 4              # n / m  (bytes saved on the wire)
    chunk: int = 4096           # n — projection block length
    seed: int = 17
    error_feedback: bool = True
    min_size: int = 1024        # leaves smaller than this ship uncompressed
    scaling: str = "contractive"   # contractive: x' = A^T A x / n;
    # "unbiased" (A^T A x / m) diverges under error feedback
    whiten: bool = True            # unit-modulus generator spectrum: the
    # full circulant is orthogonal, so A^T A / n is an exact row-space
    # projection and error feedback is stable with delta = m/n


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erfinv(u), u
    uniform in (-1, 1) from the key's 32-bit stream."""
    from repro_torch.kernels import seedgen       # kernels import core
    size = math.prod(shape)
    bits = seedgen.random_bits(key, size)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp(seedgen._u01(bits) * 2.0 + lo, min=lo)
    return (math.sqrt(2) * torch.erfinv(u)).reshape(shape)


def _leaf_key(cc: CompressionConfig, idx: int, step=0,
              device=None) -> torch.Tensor:
    from repro_torch.kernels import seedgen
    k = seedgen.fold_in(seedgen.threefry_seed(cc.seed, device), idx)
    return seedgen.fold_in(k, int(step))


def _gen(cc: CompressionConfig, idx: int, step=0,
         device=None) -> Dict[str, torch.Tensor]:
    """Generator params for the chunk projection (same on every worker)."""
    if cc.kind != "circulant":
        raise NotImplementedError(f"compression kind {cc.kind!r}: the "
                                  f"port draws circulant generators only")
    m = cc.chunk // cc.ratio
    nb = structured.n_blocks(cc.kind, m, cc.chunk)
    g = _normal(_leaf_key(cc, idx, step, device), (nb, cc.chunk))
    if cc.whiten:
        spec = torch.fft.rfft(g, dim=-1)
        spec = spec / (torch.abs(spec) + 1e-20)
        g = torch.fft.irfft(spec, n=cc.chunk, dim=-1) * math.sqrt(cc.chunk)
    return {"g": g}


def compress_leaf(x: torch.Tensor, cc: CompressionConfig, idx: int,
                  step=0) -> torch.Tensor:
    n = cc.chunk
    m = n // cc.ratio
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % n))
    return structured.matvec(cc.kind, _gen(cc, idx, step, x.device),
                             flat.reshape(-1, n), m)            # (K, m)


def decompress_leaf(y: torch.Tensor, cc: CompressionConfig, idx: int,
                    shape, dtype, step=0) -> torch.Tensor:
    n = cc.chunk
    m = n // cc.ratio
    g = _gen(cc, idx, step, y.device)
    yp = torch.nn.functional.pad(y, (0, n - m))
    denom = n if cc.scaling == "contractive" else m
    # A^T y: circulant transpose-correlation == circular convolution with g
    xhat = structured._circ_conv(yp, g["g"][0]) / denom          # (K, n)
    return xhat.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def _should_compress(x, cc) -> bool:
    return x.numel() >= cc.min_size


def compress_tree(tree, cc: CompressionConfig, step=0):
    idx = {id(x): i for i, x in enumerate(tree_lib.leaves(tree))}
    return tree_lib.map(lambda x: compress_leaf(x, cc, idx[id(x)], step)
                        if _should_compress(x, cc) else x, tree)


def decompress_tree(ctree, proto, cc: CompressionConfig, step=0):
    idx = {id(p): i for i, p in enumerate(tree_lib.leaves(proto))}
    return tree_lib.map(
        lambda y, p: decompress_leaf(y, cc, idx[id(p)], p.shape, p.dtype,
                                     step)
        if _should_compress(p, cc) else y, ctree, proto)


def roundtrip_with_feedback(grads, err, cc: CompressionConfig, step=0
                            ) -> Tuple[Dict, Dict, Dict]:
    """One worker's step: -> (sketch_to_allreduce, local_reconstruction,
    new_error). The caller means sketches across pods, then decompresses.
    Pass the training step to rotate the sketch."""
    g_in = tree_lib.map(lambda g, e: g.float() + e, grads, err) \
        if cc.error_feedback else grads
    sk = compress_tree(g_in, cc, step)
    recon = decompress_tree(sk, grads, cc, step)
    new_err = tree_lib.map(lambda gi, r: gi.float() - r.float(), g_in,
                           recon) if cc.error_feedback else err
    return sk, recon, new_err


def init_error(params) -> Dict:
    return tree_lib.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params)


def wire_bytes(tree, cc: CompressionConfig) -> Tuple[int, int]:
    """(uncompressed, compressed) f32 bytes crossing the pod boundary."""
    raw = comp = 0
    for x in tree_lib.leaves(tree):
        raw += x.numel() * 4
        if _should_compress(x, cc):
            k = -(-x.numel() // cc.chunk)
            comp += k * (cc.chunk // cc.ratio) * 4
        else:
            comp += x.numel() * 4
    return raw, comp
