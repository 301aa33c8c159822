"""Token sampling for the serving engine.

Port of ``repro.serving.sampler`` for greedy decoding: a row with
``temperature <= 0`` takes ``argmax`` (first index on ties, as
``jnp.argmax``). Sampled rows need the reference's stateless keys
(``jax.random.fold_in`` + ``gumbel`` over threefry), which come with the
seeded slice of the port; until then they raise.
"""
from __future__ import annotations

import numpy as np
import torch

SAMPLING_NOT_PORTED = (
    "temperature > 0 sampling is not ported yet: it needs the reference's "
    "stateless threefry keys (ROADMAP.md, section 1, item 1: seeded "
    "SRF)")


def sample_greedy(logits: torch.Tensor, temperature: np.ndarray
                  ) -> torch.Tensor:
    """logits: (B, V); temperature: (B,) -> (B,) int64 token ids."""
    if np.any(np.asarray(temperature) > 0.0):
        raise NotImplementedError(SAMPLING_NOT_PORTED)
    return torch.argmax(logits, dim=-1)
