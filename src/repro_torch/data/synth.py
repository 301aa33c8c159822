"""Deterministic synthetic data pipeline (a copy of ``repro.data.synth``,
pure numpy: the same seeds give bit-identical batches in both packages).

Streams are reproducible functions of (seed, step, shard) — a restarted or
re-sharded job regenerates byte-identical batches, which is what makes the
checkpoint/restart and elastic tests exact.

The LM stream has learnable structure (affine token recurrences with
segment resets + noise), so integration tests can assert loss decreases.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, step, shard, 0x5EED])
    return np.random.Generator(np.random.Philox(ss))


def lm_batch(vocab: int, batch: int, seq: int, step: int, seed: int = 0,
             shard: int = 0, noise: float = 0.05) -> Dict[str, np.ndarray]:
    """tokens[t+1] = (a * tokens[t] + b) % vocab within random segments."""
    g = _rng(seed, step, shard)
    a = 5
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = g.integers(0, vocab, batch)
    bvec = g.integers(1, 17, batch)
    resets = g.random((batch, seq)) < 0.02
    rnd = g.integers(0, vocab, (batch, seq))
    for t in range(seq):
        nxt = (a * toks[:, t] + bvec) % vocab
        toks[:, t + 1] = np.where(resets[:, t], rnd[:, t], nxt)
    noise_mask = g.random((batch, seq)) < noise
    noisy = np.where(noise_mask, g.integers(0, vocab, (batch, seq)),
                     toks[:, :-1])
    return {"tokens": noisy.astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def frontend_features(batch: int, length: int, dim: int, step: int,
                      seed: int = 0, shard: int = 0) -> np.ndarray:
    g = _rng(seed, step, shard ^ 0xF00D)
    return (g.standard_normal((batch, length, dim)) * 0.2).astype(np.float32)


def full_batch(cfg, batch: int, seq: int, step: int, seed: int = 0,
               shard: int = 0) -> Dict[str, np.ndarray]:
    """Batch matching configs.shapes.batch_specs for any arch family."""
    from repro_torch.models import frontends    # the feature widths
    out: Dict[str, np.ndarray] = {}
    if cfg.is_encdec:
        out.update(lm_batch(cfg.vocab, batch, seq, step, seed, shard))
        out["enc_emb"] = frontend_features(batch, cfg.enc_len,
                                           frontends.AUDIO_FEAT_DIM,
                                           step, seed, shard)
    elif cfg.frontend == "vision_stub":
        nv = min(cfg.n_vision_tokens, seq // 2)
        out.update(lm_batch(cfg.vocab, batch, seq - nv, step, seed, shard))
        out["vision_emb"] = frontend_features(batch, nv,
                                              frontends.VISION_FEAT_DIM,
                                              step, seed, shard)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        out["pos3"] = np.broadcast_to(pos, (3, batch, seq)).copy()
    else:
        out.update(lm_batch(cfg.vocab, batch, seq, step, seed, shard))
    return out
