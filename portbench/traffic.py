"""The one generator of requests and training batches: a traffic file
(``traffic/<name>.json``) holds only parameters, and the same seed gives
the same inputs.

Every seed sees the same set of prompt lengths in another order: they
come in blocks of ``strata`` requests, each block holding one length
from each of ``strata`` equal-probability bins of the log-uniform law
(the bin's midpoint in probability), shuffled by the seed. So a window
that spans a few blocks sees nearly the same mix whatever the seed, and
seeds change which tokens are sent, not how much work.

Parameters:

* ``prompt``: ``{"lo", "hi", "strata"}``: lengths in tokens,
  log-uniform on [lo, hi];
* ``max_new``: tokens a request generates;
* ``arrivals``: ``{"clients": n}``: a closed loop (a client sends its
  next request when the last one is done);
* ``train``: ``{"batch": rows, "seq": tokens}``: one step's rows.
Token ids are uniform over the vocabulary; a request's are drawn on the
host, a training step's on the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

_PROMPT, _IDS, _TRAIN = 0, 2, 5      # streams of the seed


def rng(seed: int, *keys: int) -> np.random.Generator:
    """The stream ``keys`` of ``seed``."""
    return np.random.Generator(np.random.Philox(
        np.random.SeedSequence([seed & (2 ** 64 - 1), *keys])))


def bin_lengths(dist: Dict) -> List[int]:
    """The lengths of one block: the midpoint of each of ``strata``
    equal-probability bins of the log-uniform law on [lo, hi]."""
    lo, hi, k = float(dist["lo"]), float(dist["hi"]), int(dist["strata"])
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / k
                               * math.log(hi / lo)))) for i in range(k)]


class Traffic:
    """The requests of one traffic file under one seed, by index."""

    def __init__(self, spec: Dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self._bins = bin_lengths(spec["prompt"]) if "prompt" in spec \
            else []

    def prompt_len(self, i: int) -> int:
        block, at = divmod(i, len(self._bins))
        order = rng(self.seed, _PROMPT, block).permutation(len(self._bins))
        return self._bins[order[at]]

    def prompt(self, i: int) -> np.ndarray:
        """Request i's prompt token ids (int64)."""
        return rng(self.seed, _IDS, i).integers(
            0, self.vocab, self.prompt_len(i)).astype(np.int64)

    def batch(self, step: int, device) -> Tuple["torch.Tensor",
                                                "torch.Tensor"]:
        """Training step ``step``'s (tokens, labels), each (batch, seq)
        int64, drawn on ``device`` by a generator of the step's own (no
        copy from the host, so no wait on the device): rows of seq + 1
        ids, shifted."""
        import torch
        t = self.spec["train"]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng(self.seed, _TRAIN, step).integers(2 ** 62)))
        rows = torch.randint(0, self.vocab, (int(t["batch"]),
                                             int(t["seq"]) + 1),
                             generator=gen, device=device)
        return rows[:, :-1], rows[:, 1:]
