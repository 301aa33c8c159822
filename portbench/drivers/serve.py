"""Serving traffic through the port's paged engine.

Set-up makes the weights from the seed on the card, builds one
``Engine`` with the traffic file's geometry and serves ``warmup_steps``
rounds of ``prefill_batch`` throwaway requests of one chunk each, to
their end: every shape the window uses (a prefill step is always
``prefill_batch`` x ``prefill_chunk``), so nothing builds or compiles
in the window and no request of the window waits on set-up. The window
opens as the clients start, drives ``Engine.step`` for ``--seconds``,
the clients sending as the traffic says, and closes at the end of the
step that crosses it. A ``--trace 1`` run profiles the window and
records the engine's spans.

After the window: the peak memory is read, the engine is freed, and a
sample of the requests finished in the window goes to the plain
reference (``refs/``), which runs each prompt with its served tokens.
The sample is drawn from the seed and covers every prefill row that a
first token of the window came from (one request of each row, in a slot
no other pick holds where there is one), with the longest request among
them, and at least ``check.requests`` requests. Two numbers are
compared:

* ``token_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at its position;
* ``logit_err``: the largest relative L2 distance, over the sampled
  requests, between the first-token logits row the engine sampled from
  (taken where the engine samples it) and the reference's.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from portbench import bench
from portbench.port import model_config
from portbench.traffic import Traffic, rng
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import SpanRecorder
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import SchedConfig

_CHECK, _WARM = 7, 8           # streams of the seed: the sample, warm-up


def _capture_first_rows(engine: Engine, log: List) -> None:
    """Keep every logits row the engine samples a request's first token
    from: ``(rows, [(row index, uid, slot)])`` a step (the rows tensor is
    the engine's own, so this adds no device work; the slot is None where
    the attention keeps no constant state)."""
    sample = engine._sample_rows

    def capture(rows, seqs):
        picks = [(i, s.req.uid, s.slot) for i, s in enumerate(seqs)
                 if s is not None and not s.req.out_tokens]
        if picks:
            log.append((rows, picks))
        return sample(rows, seqs)
    engine._sample_rows = capture


class Loop:
    """The closed loop of a traffic file's clients against one engine: a
    client sends its next request when its last one is done."""

    def __init__(self, engine: Engine, traffic: Traffic):
        self.engine = engine
        self.traffic = traffic
        self.requests: Dict[int, Request] = {}
        self.open: List[Request] = []
        for _ in range(int(traffic.spec["arrivals"]["clients"])):
            self._send()

    def _send(self) -> None:
        i = len(self.requests)
        r = Request(uid=i, prompt=self.traffic.prompt(i),
                    max_new=int(self.traffic.spec["max_new"]))
        self.requests[i] = r
        self.open.append(r)
        self.engine.submit(r)

    def step(self) -> None:
        self.engine.step()
        done = [r for r in self.open if r.done]
        if done:
            self.open = [r for r in self.open if not r.done]
            for _ in done:
                self._send()


def warm_up(engine: Engine, spec: Dict, vocab: int) -> None:
    """Serve ``warmup_steps`` rounds of one full chunk in every prefill
    row, each to its end, with uids no client uses."""
    e = spec["engine"]
    g = rng(0, _WARM)
    for k in range(int(spec.get("warmup_steps", 2))):
        warm = [Request(uid=-1 - k * e["prefill_batch"] - i,
                        prompt=g.integers(0, vocab, e["prefill_chunk"]),
                        max_new=1) for i in range(e["prefill_batch"])]
        for r in warm:
            engine.submit(r)
        while not all(r.done for r in warm):
            engine.step()


def engine_for(cell: bench.Cell, weights, device, spans=None
               ) -> Engine:
    """The traffic file's engine: a page pool (where the attention pages
    its KV) that every slot can fill to ``max_len``, and no more, plus
    the null page; no prefix cache."""
    e = cell.traffic["engine"]
    page, slots = int(e["page_size"]), int(e["slots"])
    width = -(-int(e["max_len"]) // page)
    sched = SchedConfig(max_batch=int(e["max_batch"]),
                        prefill_batch=int(e["prefill_batch"]),
                        prefill_chunk=int(e["prefill_chunk"]),
                        page_size=page, num_pages=slots * width + 1,
                        table_width=width, num_slots=slots + 1,
                        policy="fcfs")
    return Engine(model_config(cell.config), weights, sched=sched,
                  metrics=MetricsRegistry(), device=device, spans=spans)


def _counters(engine: Engine) -> Dict[str, float]:
    hist = engine.metrics.snapshot()["histograms"].get(
        "engine_step_seconds", {}).values()
    return {"prefill_tokens":
            engine.metrics.value_sum("engine_prefill_tokens_total"),
            "prefill_steps":
            engine.metrics.value_sum("engine_prefill_steps_total"),
            "decode_steps":
            engine.metrics.value_sum("engine_decode_steps_total"),
            "steps": sum(h["count"] for h in hist),
            "step_seconds": sum(h["sum"] for h in hist)}


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        device, t_process: float, on_window=None) -> Dict:
    """One run of a serving cell -> the run record the metric readers
    and the check read. ``on_window(engine)``, called as the window
    opens, lets a test break the timed path."""
    marks = [("imports", time.perf_counter())]
    ref = bench.reference(cell.config["reference"])
    s = ref.sizes(cell.config)
    traffic = Traffic(cell.traffic, seed, s["vocab"])
    weights = ref.make_weights(cell.config, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    spans = SpanRecorder() if trace else None
    engine = engine_for(cell, weights, device, spans)
    _sync(device)
    marks.append(("engine", time.perf_counter()))
    warm_up(engine, cell.traffic, s["vocab"])
    rows_log: List = []
    _capture_first_rows(engine, rows_log)
    if on_window is not None:
        on_window(engine)
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    _sync(device)
    before = _counters(engine)
    t0 = time.perf_counter()
    loop = Loop(engine, traffic)
    while time.perf_counter() - t0 < seconds:
        loop.step()
    _sync(device)
    t1 = time.perf_counter()
    after = _counters(engine)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    reqs = []
    for r in loop.requests.values():
        tr = r.trace
        reqs.append({"uid": r.uid, "prompt_len": len(r.prompt),
                     "out": list(r.out_tokens),
                     "queued": tr.first("queued"),
                     "first_token": tr.first("first_token"),
                     "done_at": tr.first("done"), "done": r.done,
                     "reason": r.finish_reason})
    record = {"kind": "serve", "cell": cell.name, "sizes": s,
              "engine": cell.traffic["engine"], "t0": t0, "t1": t1,
              "window_s": t1 - t0, "setup_s": t0 - t_process,
              "setup_phases": bench.phases(t_process,
                                           marks + [("warm-up", t0)]),
              "counters": {k: after[k] - before[k] for k in after},
              "requests": reqs, "memory_peak_bytes": int(peak)}
    if spans is not None:
        record["spans"] = [{"name": sp.name, "t": sp.t0, "t1": sp.t1,
                            "uid": sp.uid, **sp.args}
                           for sp in spans.snapshot()]
    if prof is not None:
        from portbench import trace as trace_lib
        record["trace"] = trace_lib.events(prof)
        del prof
    # the program's state goes before the reference runs
    firsts = {uid: (rows, i, slot) for rows, picks in rows_log
              for i, uid, slot in picks}
    for q in reqs:
        if q["uid"] in firsts:
            q["row"], q["slot"] = firsts[q["uid"]][1:]
    in_window = [q for q in reqs if q["first_token"] is not None
                 and t0 <= q["first_token"] <= t1]
    finished = [q for q in reqs if q["done"] and q["done_at"] <= t1
                and q["reason"] in ("length", "eos")]
    sample = pick_sample(finished, seed, int(cell.traffic["check"]
                                             ["requests"]))
    rows = {q["uid"]: firsts[q["uid"]][0][firsts[q["uid"]][1]]
            [: s["vocab"]].float().clone() for q in sample}
    del engine, loop, rows_log, firsts
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    # attempted: the requests of the TTFT tail; failed: those that ended
    # otherwise than by length or EOS (one still decoding is not failed)
    record["attempted"] = len(in_window)
    record["failed"] = sum(1 for q in in_window if q["done"] and (
        q["reason"] not in ("length", "eos") or not q["out"]))
    record["check"] = compare(cell, ref, weights, traffic, sample, rows)
    return record


def pick_sample(done: List[Dict], seed: int, count: int) -> List[Dict]:
    """Requests of ``done`` drawn from the seed, in uid order: the one
    with the longest prompt; one of each prefill ``row`` that no pick
    covers yet, in a ``slot`` that no pick holds where there is one; then
    more, up to ``count`` in all."""
    if not done:
        return []
    done = sorted(done, key=lambda q: q["uid"])
    order = [done[i] for i in rng(seed, _CHECK).permutation(len(done))]
    picked = {}

    def take(q):
        picked[q["uid"]] = q
        rows.add(q.get("row"))
        slots.add(q.get("slot"))
    rows, slots = set(), set()
    take(max(done, key=lambda q: (q["prompt_len"], -q["uid"])))
    for row in sorted({q.get("row") for q in done} - {None}):
        if row not in rows:
            of_row = [q for q in order if q.get("row") == row]
            take(next((q for q in of_row if q.get("slot") not in slots),
                      of_row[0]))
    for q in order:
        if len(picked) >= count:
            break
        take(q)
    return [picked[u] for u in sorted(picked)]


def compare(cell: bench.Cell, ref, weights, traffic: Traffic,
            sample: List[Dict], rows: Dict, quant: Optional[str] = None
            ) -> Dict[str, float]:
    """The compared numbers of a sample: the reference over each prompt
    and its served tokens."""
    gap, err = 0.0, 0.0
    for q in sample:
        prompt = traffic.prompt(q["uid"])
        out = list(q["out"])
        logits = ref.logits_from(cell.config, weights,
                                 list(prompt) + out[:-1], len(prompt),
                                 quant=quant)
        for j, tok in enumerate(out):
            gap = max(gap, float(logits[j].max() - logits[j][tok]))
        row = rows[q["uid"]].to(logits.device)
        err = max(err, float(torch.linalg.vector_norm(row - logits[0])
                             / torch.linalg.vector_norm(logits[0])))
    return {"token_gap": gap, "logit_err": err}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def control(cell: bench.Cell, seed: int, device, quant: str = "fp8"
            ) -> Dict[str, float]:
    """The check's numbers with the reference at ``quant`` put in the
    program's place, on the sample a run would draw (from the requests
    the window would finish first: the traffic's first ones): at each
    sampled prompt, the token the lower precision puts first, read
    against the float32 reference, and its logits row."""
    ref = bench.reference(cell.config["reference"])
    s = ref.sizes(cell.config)
    traffic = Traffic(cell.traffic, seed, s["vocab"])
    weights = ref.make_weights(cell.config, seed, device)
    # as many requests as a run compares: a row each, and the longest
    count = max(int(cell.traffic["check"]["requests"]),
                int(cell.traffic["engine"]["prefill_batch"]) + 1)
    pool = [{"uid": i, "prompt_len": traffic.prompt_len(i)}
            for i in range(8 * count)]
    sample = pick_sample(pool, seed, count)
    rows = {}
    for q in sample:
        low = ref.logits_from(cell.config, weights, traffic.prompt(q["uid"]),
                              q["prompt_len"], quant=quant)[0]
        q["out"] = [int(low.argmax())]
        rows[q["uid"]] = low
    return compare(cell, ref, weights, traffic, sample, rows)
