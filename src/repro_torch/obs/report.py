"""Serving reporter: the ONE place the port's serving stack prints from.

Port of ``repro.obs.report`` (pure Python; it reads the registry and the
finished requests' traces). ``launch/serve.py`` and everything under
``serving/`` are print-free (``tests/test_torch_serving.py`` pins it);
all human-facing output routes through a :class:`Reporter`, so the
summary lines and a metrics report read the same registry.

Usage:

    reporter = Reporter()
    on_step = reporter.periodic(registry, every_s=2.0)
    engine.run(on_step=on_step)            # one-line report every 2 s
    reporter.final(registry, done)         # latency percentiles + dump
"""
from __future__ import annotations

import math
import sys
import time
from typing import Callable, IO, Iterable, Optional

from . import trace as trace_lib


def _fmt_ms(v: float) -> str:
    return "nan" if v is None or math.isnan(v) else f"{v * 1e3:.1f}"


class Reporter:
    """Formats and prints serving telemetry read from a registry."""

    def __init__(self, stream: Optional[IO[str]] = None, prefix: str = ""):
        self.stream = stream or sys.stdout
        self.prefix = prefix

    def line(self, msg: str) -> None:
        print(self.prefix + msg, file=self.stream, flush=True)

    # -- periodic one-liner --------------------------------------------------

    def periodic(self, registry, every_s: float = 2.0
                 ) -> Callable[[object], None]:
        """Returns an ``on_step`` callback: every ``every_s`` seconds of
        engine stepping, print one line of live registry state."""
        state = {"t0": time.perf_counter(), "last": time.perf_counter(),
                 "last_tokens": 0}

        def on_step(_engine) -> None:
            now = time.perf_counter()
            if now - state["last"] < every_s:
                return
            tokens = registry.value_sum("engine_tokens_total")
            dt = now - state["last"]
            rate = (tokens - state["last_tokens"]) / dt if dt > 0 else 0.0
            state["last"], state["last_tokens"] = now, tokens
            self.line(
                f"[metrics] t={now - state['t0']:.1f}s tokens={int(tokens)} "
                f"tok/s={rate:.1f} "
                f"done={int(registry.value_sum('engine_requests_total'))} "
                f"running={int(registry.value_sum('sched_running'))} "
                f"waiting={int(registry.value_sum('sched_waiting'))} "
                f"free_pages={int(registry.value_sum('sched_free_pages'))} "
                f"preempt={int(registry.value_sum('engine_preemptions_total'))} "
                f"migrations="
                f"{int(registry.value_sum('router_migrations_total'))}"
                + self._prefix_fragment(registry)
                + self._ft_fragment(registry))
        return on_step

    @staticmethod
    def _prefix_fragment(registry) -> str:
        """Prefix-cache hit rate for the periodic line — only printed
        once any lookup has happened, so cache-less runs keep the exact
        pre-prefix line format."""
        lookups = registry.value_sum("prefix_lookups_total")
        if not lookups:
            return ""
        hits = registry.value_sum("prefix_hits_total")
        return f" hit_rate={hits / lookups:.2f}"

    @staticmethod
    def _ft_fragment(registry) -> str:
        """Fault-tolerance tail for the periodic line — only printed once
        any FT transition has happened, so non-FT runs keep the exact
        pre-FT line format."""
        dead = registry.value_sum("router_dead_replicas")
        degraded = registry.value_sum("router_degraded")
        counts = {k: int(registry.value_sum(f"router_{k}_total"))
                  for k in ("quarantined", "rescued", "replayed", "shed",
                            "revived", "failed")}
        counts["expired"] = int(registry.value_sum("engine_expired_total"))
        if not dead and not degraded and not any(counts.values()):
            return ""
        frag = (f" dead={int(dead)}"
                f" state={'degraded' if degraded else 'ok'}")
        frag += "".join(f" {k}={v}" for k, v in counts.items() if v)
        return frag

    # -- final dump ----------------------------------------------------------

    def final(self, registry, requests: Iterable = (),
              dump_path: Optional[str] = None) -> None:
        """Per-request latency percentiles + counter totals, all from the
        single registry / the finished requests' traces. ``dump_path``
        additionally writes the Prometheus text exposition there and the
        JSONL event stream to ``<dump_path>.events.jsonl``."""
        summ = trace_lib.latency_summary(requests)
        self.line("[metrics] ---- final ----")
        self.line(
            f"[metrics] requests={int(registry.value_sum('engine_requests_total'))} "
            f"tokens={int(registry.value_sum('engine_tokens_total'))} "
            f"prefill_steps="
            f"{int(registry.value_sum('engine_prefill_steps_total'))} "
            f"decode_steps="
            f"{int(registry.value_sum('engine_decode_steps_total'))} "
            f"preemptions="
            f"{int(registry.value_sum('engine_preemptions_total'))}")
        for kind in ("ttft", "tpot", "queue", "e2e"):
            pct = summ[f"{kind}_s"]
            self.line(f"[metrics] {kind}_ms " + " ".join(
                f"{k}={_fmt_ms(v)}" for k, v in pct.items()))
        mig = registry.value_sum("router_migrations_total")
        sub = registry.value_sum("router_submitted_total")
        if sub:
            heads = registry.snapshot()["gauges"].get("router_headroom", {})
            self.line(f"[metrics] router submitted={int(sub)} "
                      f"migrations={int(mig)} headroom={heads}")
        lookups = registry.value_sum("prefix_lookups_total")
        if lookups:
            self.line(
                f"[metrics] prefix lookups={int(lookups)} "
                f"hits={int(registry.value_sum('prefix_hits_total'))} "
                f"hit_rate={registry.value_sum('prefix_hits_total') / lookups:.2f} "
                f"hit_tokens="
                f"{int(registry.value_sum('prefix_hit_tokens_total'))}")
        ft = self._ft_fragment(registry)
        if ft:
            self.line("[metrics] ft" + ft)
        qual = registry.snapshot()["gauges"].get("srf_quality", {})
        if qual:
            self.line(f"[metrics] srf_quality {qual}")
        kern = registry.snapshot()["histograms"].get(
            "kernel_dispatch_seconds", {})
        for lbl, cs in sorted(kern.items()):
            self.line(f"[metrics] kernel {lbl} n={cs['count']} "
                      f"mean_ms={_fmt_ms(cs['sum'] / max(1, cs['count']))}")
        if dump_path:
            with open(dump_path, "w") as f:
                f.write(registry.prometheus_text())
            with open(dump_path + ".events.jsonl", "w") as f:
                n = registry.dump_events_jsonl(f)
            self.line(f"[metrics] dumped {dump_path} "
                      f"(+{n} events -> {dump_path}.events.jsonl)")
