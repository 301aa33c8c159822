"""Deterministic fault injection for the serving stack.

Port of ``repro.serving.chaos``. For tests and smoke runs only: every
recovery path of ``serving/ft.py`` and ``serving/mesh/router.py`` can
be driven without a real hardware fault. Nothing in the serving path
imports this module, and ``serving/__init__`` does not export it.
``ChaosEngine`` wraps a live :class:`~repro_torch.serving.engine.Engine`
and injects one scripted fault at a chosen step:

``raise``
    ``ChaosError`` escapes ``step()``: the hard crash (a lost device).
    The router's exception handler quarantines the replica.
``hang``
    the engine's step-time clock (``Engine.clock``) starts reporting a
    large stall, so the recorded ``engine_step_seconds`` inflate while
    the real steps go on, which drives the watchdog's
    EMA-against-peer-median slow detector as a real stall would,
    without sleeping.
``reject``
    admission is corrupted (``sched.admit`` returns nothing), so queued
    work never starts: the stuck detector's case.
``oom``
    the page and slot pools are exhausted by hostage allocations, topped
    up every step so that eviction cannot win the pages back: sustained
    allocator exhaustion, also caught by the stuck detector.

Faults are deterministic: ``ChaosPlan`` pins the kind and the step, and
:meth:`ChaosPlan.from_seed` draws both from a seed (Python's
``random``, so it draws the reference's plans). ``heal()`` undoes the
fault (returns the hostage pages, restores admission, stops the stall)
so that a ``Router.revive`` probe can succeed: the simulated swap of a
broken host.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

FAULT_KINDS = ("raise", "hang", "reject", "oom")


class ChaosError(RuntimeError):
    """An injected failure. Real serving code never raises it."""


@dataclass
class ChaosPlan:
    """One scripted fault: ``kind`` trips once ``at_step`` chaos-engine
    steps have been attempted, and stays tripped until ``heal()``."""
    kind: str
    at_step: int = 5
    stall_s: float = 30.0   # reported stall a step for kind="hang"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    @classmethod
    def from_seed(cls, seed: int, at_step=(3, 9)) -> "ChaosPlan":
        rng = random.Random(seed)
        return cls(kind=FAULT_KINDS[rng.randrange(len(FAULT_KINDS))],
                   at_step=rng.randrange(at_step[0], at_step[1]))


class _StallClock:
    """Stands in for ``time.perf_counter`` and adds ``stall`` seconds to
    each engine step. The engine reads its clock exactly twice a step
    (start and stop), so advancing the offset on every second call
    inflates each recorded ``engine_step_seconds`` observation by
    ``stall`` without blocking the process."""

    def __init__(self, base):
        self._base = base
        self._offset = 0.0
        self._calls = 0
        self.stall = 0.0

    def __call__(self) -> float:
        self._calls += 1
        if self._calls % 2 == 0:
            self._offset += self.stall
        return self._base() + self._offset


class ChaosEngine:
    """Engine wrapper that injects the fault described by ``fault``.

    Everything but ``step``, ``run`` and ``heal`` goes to the wrapped
    engine, so the router drives a ``ChaosEngine`` like any replica. The
    attribute is ``fault``, not ``plan``, so that it never shadows
    ``Engine.plan``, the PoolPlan the router's placement reads."""

    def __init__(self, engine, fault: ChaosPlan):
        self._eng = engine
        self.fault = fault
        self.steps_seen = 0
        self.tripped = False
        self.healed = False
        self._hostage_pages: list = []
        self._hostage_slots: list = []
        self._orig_admit = engine.sched.admit
        self._stall_clock = None
        if fault.kind == "hang":
            self._stall_clock = _StallClock(engine.clock)
            engine.clock = self._stall_clock

    def __getattr__(self, name):
        return getattr(self._eng, name)

    # -- fault machinery -------------------------------------------------

    def _trip(self) -> None:
        k = self.fault.kind
        self.tripped = True
        if k == "raise":
            raise ChaosError(
                f"injected engine failure at chaos step {self.steps_seen}")
        if k == "hang":
            self._stall_clock.stall = self.fault.stall_s
        elif k == "reject":
            self._eng.sched.admit = lambda: []
        elif k == "oom":
            # topped up on every step: eviction frees pages, so a single
            # grab would let the replica limp along and never look stuck
            self._grab_pool()

    def _grab_pool(self) -> None:
        sched = self._eng.sched
        got = sched.alloc.alloc(sched.alloc.free_pages)
        if got:
            self._hostage_pages.extend(got)
        if sched.slot_alloc is not None:
            got = sched.slot_alloc.alloc(sched.slot_alloc.free_pages)
            if got:
                self._hostage_slots.extend(got)
        sched._sync_gauges()

    def heal(self) -> None:
        """Undo the fault (the simulated host swap), so that a later
        ``Router.revive`` probe can succeed."""
        self.healed = True
        if self._stall_clock is not None:
            self._stall_clock.stall = 0.0
        self._eng.sched.admit = self._orig_admit
        if self._hostage_pages:
            self._eng.sched.alloc.free(self._hostage_pages)
            self._hostage_pages = []
        if self._hostage_slots:
            self._eng.sched.slot_alloc.free(self._hostage_slots)
            self._hostage_slots = []
        self._eng.sched._sync_gauges()

    # -- engine surface --------------------------------------------------

    def step(self) -> bool:
        self.steps_seen += 1
        if not self.healed and self.steps_seen >= self.fault.at_step:
            self._trip()
        return self._eng.step()

    def run(self, on_step=None):
        """``Engine.run`` through the injecting ``step`` (the wrapped
        engine's own ``run`` would call its own step and miss it)."""
        tracked = [s.req for s in self._eng.sched.waiting
                   + self._eng.sched.running]
        stall = 0
        while self._eng.sched.has_work:
            progressed = self.step()
            if on_step is not None:
                on_step(self)
            stall = 0 if progressed else stall + 1
            if stall > 2:
                raise RuntimeError(
                    "scheduler stalled: pool too small for the remaining "
                    "requests (or a chaos fault is active)")
        return [r for r in tracked if r.done]
