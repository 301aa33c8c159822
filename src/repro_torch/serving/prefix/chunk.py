"""Chunked-prefill scheduling policy: budgeted prefill chunks that
interleave with decode steps.

The base engine is prefill-first: while ANY sequence is still
prefilling, decode waits. That maximizes prefill locality but lets one
long cold prompt starve every decoding request (TPOT spikes for the
whole batch). With a :class:`ChunkPolicy` attached the engine instead

* alternates: when both prefill and decode work exist, every
  ``decode_every``-th step runs decode first (prefill-only and
  decode-only phases are unaffected), and
* budgets: each prefill step spends at most ``chunk_tokens`` prompt
  tokens TOTAL across its batch rows, distributed greedily in rank
  order (each row still bounded by the jit shape's per-row chunk), so
  admission of a long prompt is spread over several smaller steps
  instead of one maximal one.

Greedy outputs are batch-composition independent (rows are masked and
independent in ``transformer.paged_step``; MoE capacity is sized on
valid tokens), so interleaving and re-budgeting chunks NEVER changes
tokens — only their timing. The policy is attached only when the prefix
subsystem is enabled; a cold engine keeps the exact legacy order.

Port: a copy of ``repro.serving.prefix.chunk`` (host Python; the
port keeps its own copy and imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.obs import spans as obs_spans


@dataclass(frozen=True)
class ChunkConfig:
    """``chunk_tokens=0`` means the full jit budget (prefill_batch x
    prefill_chunk — no extra splitting); ``decode_every=0`` disables
    interleaving (prefill-first, like the cold engine)."""
    chunk_tokens: int = 0
    decode_every: int = 2


class ChunkPolicy:
    """Host-side pacing state; one per engine."""

    def __init__(self, cfg: ChunkConfig, spans=None):
        self.cfg = cfg
        self.spans = spans if spans is not None else obs_spans.NOOP
        self._mixed_steps = 0

    def spans_steps(self, work, per_row: int, max_rows: int) -> bool:
        """True when the pending prefill work cannot finish in ONE step
        under the current budget. Only then is a decode detour worth it:
        a single quick prefill step delays decode less than a full
        interleave round, so yielding for it would tax steady-state TPOT
        (e.g. the tiny suffix prefills of prefix-cache hits) without
        protecting anything."""
        budget = self.cfg.chunk_tokens or per_row * max_rows
        if len(work) > max_rows:
            return True
        return sum(min(s.prompt_len - s.prefill_pos, per_row)
                   for s in work) > budget

    def decode_turn(self) -> bool:
        """Called once per step while BOTH prefill and decode work
        exist; True -> the engine runs decode this step. Every
        ``decode_every``-th mixed step yields to decode, so decoding
        sequences make progress at a bounded TPOT cost while long
        prompts chunk in."""
        if self.cfg.decode_every <= 0:
            return False
        self._mixed_steps += 1
        if self._mixed_steps % self.cfg.decode_every == 0:
            self.spans.instant("decode_yield", mixed_steps=self._mixed_steps)
            return True
        return False

    def plan(self, work, per_row: int,
             max_rows: int) -> List[Tuple[object, int]]:
        """Distribute the step's token budget over prefilling sequences
        (already rank-ordered): returns [(seq, n_tokens)] with
        ``n <= per_row`` each and ``sum(n) <= max(chunk_tokens,
        per_row)``. The head sequence always gets at least one token —
        a budget below one row must still make progress."""
        budget = self.cfg.chunk_tokens or per_row * max_rows
        out: List[Tuple[object, int]] = []
        for seq in work[:max_rows]:
            n = min(seq.prompt_len - seq.prefill_pos, per_row, budget)
            if n <= 0:
                break
            out.append((seq, n))
            budget -= n
            if budget <= 0:
                break
        if not out and work:
            seq = work[0]
            out.append((seq, min(seq.prompt_len - seq.prefill_pos,
                                 per_row, 1)))
        return out
