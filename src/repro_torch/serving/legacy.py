"""Legacy per-slot serving engine: the paged engine's test oracle, and the
baseline the paged engine is measured against.

Port of ``repro.serving.legacy``. The paged engine (``serving.engine``)
serves every ported family; nothing routes here in production
(``launch/serve.py`` keeps ``--legacy`` for A/B runs). The per-slot loop
survives because its simplicity makes it an independent implementation:
the paged engine's tokens are pinned to this one's, greedy and sampled
(``tests/test_torch_legacy.py``, the port's counterpart of
``tests/test_engine_parity.py``).

Requests enter a queue; a free slot is filled by prefilling the request's
prompt (batch 1) into a fresh cache (``transformer.init_serve_cache``:
full KV, int8 KV, MLA latents or the SRF state; the SSD state of the
ssm and hybrid families; an enc-dec request's encoder memory, from its
``enc_emb``), and every active slot then decodes
one token a step, slot after slot, each a batch-1 ``make_serve_step``
call. Sampling uses the paged engine's stateless per-request keys
(``sampler.sample_stateless``: noise from ``(base_key, uid, token
index)``, never from engine state), which is what lets sampled decode
match the paged engine's too. EOS or ``max_new`` stops a request; a
request whose first token already does finishes at prefill.

Differences from the reference: ``Engine`` takes the ``device`` its
caches live on (default ``"cuda"``, like the paged engine), and counts
live logit rows that are not all finite in ``nonfinite_rows``, as the
paged engine does.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import seedgen
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer as model_lib

from .engine import Request
from .sampler import sample_stateless

warnings.warn(
    "repro_torch.serving.legacy is deprecated; use the paged engine "
    "(repro_torch.serving.Engine: continuous batching over pooled paged "
    "caches). The per-slot lock-step engine is kept only as the test "
    "oracle and the benchmark baseline.",
    DeprecationWarning, stacklevel=2)


class Engine:
    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self._prefill = step_lib.make_prefill_step(cfg)
        self._step = step_lib.make_serve_step(cfg)
        self.caches: List[Optional[Dict]] = [None] * batch_slots
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.stats: Dict[str, float] = {"tokens": 0, "requests": 0}
        self.nonfinite_rows = 0
        # stateless sampling keys: the paged engine's derivation
        # (fold_in(fold_in(base, uid), position)), so a request sampled
        # here and there draws the same noise at every token
        self._base_key = seedgen.threefry_seed(seed, self.device)

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _pick(self, req: Request, logits: torch.Tensor) -> int:
        """Sample one token for ``req`` from (V,) logits: a batch-1 call
        of the shared stateless sampler (the same token as any batched
        call with the same (uid, position))."""
        toks = sample_stateless(
            self._base_key, np.array([req.uid & 0xFFFFFFFF], np.int64),
            np.array([len(req.out_tokens)], np.int64), logits[None, :],
            np.array([req.temperature], np.float32),
            np.array([req.top_k], np.int64),
            np.array([req.top_p], np.float32))
        bad = (~torch.isfinite(logits)).any()
        tok = int(toks[0])
        self.nonfinite_rows += int(bad)
        return tok

    def _finish_if_done(self, req: Request, tok: int, now: float) -> bool:
        if tok == req.eos_id or len(req.out_tokens) >= req.max_new:
            req.done = True
            req.t_done = now
            self.stats["requests"] += 1
            return True
        return False

    def _fill_slots(self, extra_batch: Optional[Dict] = None) -> None:
        """Prefill queued requests into free slots; ``extra_batch`` (for
        example a vision prefix's "vision_emb" and "pos3") is merged into
        every prefill batch."""
        for i in range(self.slots):
            # loop: a request whose FIRST token already meets eos/max_new
            # finishes at prefill and never holds the slot (the paged
            # engine's finish-at-prefill path)
            while self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                batch = {"tokens": torch.as_tensor(
                    np.asarray(req.prompt)[None, :], device=self.device)}
                if req.enc_emb is not None:
                    batch["enc_emb"] = torch.as_tensor(
                        np.asarray(req.enc_emb), device=self.device)[None]
                if extra_batch:
                    batch.update(extra_batch)
                cache = model_lib.init_serve_cache(self.cfg, 1,
                                                   self.max_len, self.device)
                logits, cache = self._prefill(self.params, batch, cache)
                nxt = self._pick(req, logits[0, -1, : self.cfg.vocab])
                req.out_tokens.append(nxt)
                now = time.perf_counter()
                req.t_first = now
                self.stats["tokens"] += 1
                if self._finish_if_done(req, nxt, now):
                    continue
                self.caches[i] = cache
                self.active[i] = req

    def _decode_once(self) -> None:
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = torch.tensor([[req.out_tokens[-1]]], device=self.device)
            _, logits, self.caches[i] = self._step(self.params,
                                                   self.caches[i], tok)
            t = self._pick(req, logits[0])
            req.out_tokens.append(t)
            self.stats["tokens"] += 1
            if self._finish_if_done(req, t, time.perf_counter()):
                self.active[i] = None
                self.caches[i] = None

    def run(self, extra_batch: Optional[Dict] = None) -> List[Request]:
        """Drain the queue; returns the completed requests.
        ``extra_batch`` goes into every prefill batch (``_fill_slots``)."""
        tracked = list(self.queue)
        while self.queue or any(a is not None for a in self.active):
            self._fill_slots(extra_batch)
            self._decode_once()
        return [r for r in tracked if r.done]
