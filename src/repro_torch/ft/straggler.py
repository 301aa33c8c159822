"""Straggler detection & mitigation policy (a copy of
``repro.ft.straggler``, pure Python).

On a real fleet every host reports step wall-times; the controller flags
hosts whose EMA exceeds ``threshold`` x the fleet median and applies a
policy (re-assign that host's data shard to a hot spare / exclude it and
shrink the data axis via ft.elastic). The detection logic is pure and
unit-tested with synthetic timings; the trainer wires it to real timers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class StragglerConfig:
    ema: float = 0.7            # smoothing of per-host step time
    threshold: float = 1.8      # x median -> straggler
    grace_steps: int = 3        # consecutive flags before acting
    policy: str = "reassign"    # reassign | exclude | warn


@dataclass
class HostState:
    ema_time: Optional[float] = None
    flags: int = 0
    excluded: bool = False
    shard: int = -1


class StragglerWatchdog:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.hosts: Dict[int, HostState] = {
            i: HostState(shard=i) for i in range(n_hosts)}
        self.spare_shards: List[int] = []
        self.events: List[dict] = []

    def record(self, host: int, step: int, dt: float) -> Optional[dict]:
        h = self.hosts[host]
        h.ema_time = dt if h.ema_time is None else (
            self.cfg.ema * h.ema_time + (1 - self.cfg.ema) * dt)
        med = self._median()
        if med is None:
            return None
        if h.ema_time > self.cfg.threshold * med and not h.excluded:
            h.flags += 1
            if h.flags >= self.cfg.grace_steps:
                return self._act(host, step, med)
        else:
            h.flags = 0
        return None

    def _median(self) -> Optional[float]:
        ts = sorted(h.ema_time for h in self.hosts.values()
                    if h.ema_time is not None and not h.excluded)
        if len(ts) < max(2, len(self.hosts) // 2):
            return None
        return ts[len(ts) // 2]

    def _act(self, host: int, step: int, median: float) -> dict:
        h = self.hosts[host]
        ev = {"step": step, "host": host, "ema": h.ema_time,
              "median": median, "action": self.cfg.policy}
        if self.cfg.policy == "exclude":
            h.excluded = True
            self.spare_shards.append(h.shard)
            h.shard = -1
        elif self.cfg.policy == "reassign":
            # swap shards with the fastest host (it double-buffers); with
            # every other host excluded there is no one to reassign to —
            # degrade to a warn event instead of crashing the controller
            candidates = [x for x in self.hosts.values()
                          if not x.excluded and x is not h]
            if not candidates:
                ev["action"] = "warn"
            else:
                fastest = min(candidates, key=lambda x: x.ema_time or 1e9)
                ev["reassigned_to_host"] = [k for k, v in self.hosts.items()
                                            if v is fastest][0]
                fastest.shard, h.shard = h.shard, fastest.shard
        h.flags = 0
        self.events.append(ev)
        return ev

    def active_shard_map(self) -> Dict[int, int]:
        return {k: v.shard for k, v in self.hosts.items() if not v.excluded}
