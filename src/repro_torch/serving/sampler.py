"""Token sampling for the serving engine: temperature / top-k / top-p.

Port of ``repro.serving.sampler`` (``sample``, ``sample_stateless``):
one fully batched call in which every row carries its own (temperature,
top_k, top_p); ``temperature <= 0`` selects greedy ``argmax`` for that
row (first index on ties, as ``jnp.argmax``).

Engines draw through :func:`sample_stateless`: the noise of row ``i`` is
a pure function of ``(base_key, uid[i], position[i])``:
``gumbel(fold_in(fold_in(base_key, uid), position))`` over the threefry
port in ``kernels.seedgen``, with the reference's keys and bits, so a
request's sampled stream does not depend on batch composition, batch
slot or engine state. :func:`sample` draws one batch-wide (B, V) noise
from a single key, as ``jax.random.gumbel(key, (B, V))`` does. Plain
PyTorch on either device (the reference computes it outside any Pallas
kernel too).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.kernels import seedgen

Rows = Union[np.ndarray, torch.Tensor]


def row_keys(base_key: torch.Tensor, uids: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys fold_in(fold_in(base_key, uid), position) per row."""
    k = seedgen.fold_in(base_key.expand(uids.shape[0], 2), uids)
    return seedgen.fold_in(k, positions)


def _gumbel_max(lf: torch.Tensor, temperature: Rows, top_k: Rows,
                top_p: Rows, noise) -> torch.Tensor:
    """The shared masking and Gumbel-max of both samplers: lf (B, V) f32
    logits; ``noise(v)`` -> (B, v) Gumbel noise. Sort once descending,
    keep the top-k ranks and the tokens whose cumulative probability
    before them is below top_p (the first always survives), take the
    argmax of the surviving logits plus the noise; greedy rows take
    ``argmax`` of the logits."""
    dev = lf.device
    b, v = lf.shape
    argmax = torch.argmax(lf, dim=-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    greedy = temperature <= 0.0
    temp = torch.where(greedy, torch.ones_like(temperature),
                       torch.clamp(temperature, min=1e-6))
    scaled = lf / temp[:, None]

    order = torch.argsort(-scaled, dim=-1, stable=True)     # (B, V) desc
    sorted_logits = torch.gather(scaled, -1, order)
    ranks = torch.arange(v, device=dev)[None, :]
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)
    keep = ranks < k_eff[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    keep &= (cum - probs) < top_p[:, None]
    keep |= ranks == 0

    masked = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, -float("inf")))
    pick = torch.argmax(masked + noise(v), dim=-1)
    sampled = torch.gather(order, -1, pick[:, None])[:, 0]
    return torch.where(greedy, argmax, sampled)


def sample(key: torch.Tensor, logits: torch.Tensor, temperature: Rows,
           top_k: Rows, top_p: Rows) -> torch.Tensor:
    """logits: (B, V); temperature, top_p: (B,) float; top_k: (B,) int
    (0 = disabled); key: (2,) words (``seedgen.threefry_seed``) -> (B,)
    int64 token ids. The noise is ``jax.random.gumbel(key, (B, V))``:
    one key, counters over the flattened (B, V) grid."""
    b, v = logits.shape
    key = seedgen.words(key, logits.device)
    return _gumbel_max(logits.float(), temperature, top_k, top_p,
                       lambda v_: seedgen.gumbel(key, b * v_).view(b, v_))


def sample_stateless(base_key: torch.Tensor, uids: Rows, positions: Rows,
                     logits: torch.Tensor, temperature: Rows, top_k: Rows,
                     top_p: Rows) -> torch.Tensor:
    """logits: (B, V); uids, positions: (B,) words (padded rows may carry
    anything: their token is discarded); temperature, top_p: (B,) float;
    top_k: (B,) int (0 = disabled); base_key: (2,) words
    (``seedgen.threefry_seed``) -> (B,) int64 token ids on logits' device.

    Sort once descending, keep the top-k ranks and the tokens whose
    cumulative probability before them is below top_p (the first always
    survives), then Gumbel-max over the surviving logits. A batch with no
    sampled row takes ``argmax`` directly (the same tokens, without the
    sort and the noise).
    """
    dev = logits.device
    lf = logits.float()
    if isinstance(temperature, torch.Tensor):
        all_greedy = bool((temperature <= 0.0).all())
    else:                           # host values: decided without a sync
        all_greedy = bool(np.all(np.asarray(temperature) <= 0.0))
    if all_greedy:
        return torch.argmax(lf, dim=-1)
    keys = row_keys(seedgen.words(base_key, dev), seedgen.words(uids, dev),
                    seedgen.words(positions, dev))
    return _gumbel_max(lf, temperature, top_k, top_p,
                       lambda v: seedgen.gumbel(keys, v))
