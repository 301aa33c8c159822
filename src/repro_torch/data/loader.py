"""Sharded, prefetching data loader (port of ``repro.data.loader``).

Each *data shard* (a host group on the `pod` x `data` axes) generates its
slice of the global batch locally — no central dispenser, O(1) host memory,
and deterministic restart (stream is a function of (seed, step, shard)).

Prefetch runs on a background thread (depth-k queue) so host-side batch
synthesis overlaps device compute — the standard input-pipeline overlap.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


class ShardedLoader:
    def __init__(self, make_batch: Callable[[int, int], Dict[str, np.ndarray]],
                 n_shards: int = 1, shard_id: int = 0, prefetch: int = 2,
                 start_step: int = 0):
        """make_batch(step, shard_id) -> dict of np arrays (the LOCAL slice)."""
        self.make_batch = make_batch
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.prefetch = prefetch
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.make_batch(step, self.shard_id)
            except Exception as e:   # surface producer errors to consumers
                self._q.put(("__error__", e))
                return
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self) -> Iterator:
        self.start()
        while True:
            step, batch = self._q.get()
            if step == "__error__":
                raise RuntimeError("data producer failed") from batch
            yield step, batch

    def reset(self, step: int):
        """Elastic/restart: resume the stream from a checkpointed step."""
        self.stop()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=max(1, self.prefetch))
        self._step = step
        return self


def device_batch(batch: Dict[str, np.ndarray], device="cuda"
                 ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device`` (int32 token ids stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
