"""Fault-tolerant checkpointing: atomic, integrity-checked, async, keep-k.

Port of ``repro.checkpoint.manager``, with its on-disk layout, so either
package restores the other's checkpoints:

    <dir>/step_00000420/arrays.npz     flattened key-path -> array
    <dir>/step_00000420/manifest.json  shapes, dtypes, sha256, metadata
    <dir>/step_00000420/COMMITTED      written last -> crash-safe marker

Writes go to ``.tmp-<step>`` and are renamed only after fsync — a job
killed mid-save never corrupts the latest checkpoint. ``restore`` picks
the newest COMMITTED step. bf16 arrays round-trip via a uint16 view.
Key paths are the reference's ("params/segments/0/attn/wq",
``repro_torch.tree``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

_BF16 = "bfloat16"

# Key-path aliases applied on restore when a target key is missing:
# (regex, replacement) rewriting the NEW layout's key into the legacy
# stored key (SRF params moved from one dict '.../srf/g' to a tuple of
# per-block dicts '.../srf/0/g').
LEGACY_KEY_ALIASES: List[Tuple[str, str]] = [
    (r"(^|/)srf/0/", r"\1srf/"),
]


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as stored (bf16 as its uint16 bits) and the
    dtype name the manifest records."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), _BF16
    a = t.numpy().copy()
    return a, str(a.dtype)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(1) if async_save else None
        self._pending: Optional[Future] = None

    # ---------------- save ----------------

    def save(self, step: int, tree, metadata: Optional[Dict] = None,
             blocking: bool = False):
        """Snapshot to host memory synchronously, write in the background."""
        host = {k: _host(v) for k, v in tree_lib.leaves_with_path(tree)}
        meta = dict(metadata or {})
        self.wait()
        if self._pool is None or blocking:
            self._write(step, host, meta)
        else:
            self._pending = self._pool.submit(self._write, step, host, meta)
        return step

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               meta: Dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = os.path.join(self.dir, f".tmp-{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "metadata": meta, "arrays": {}}
        for k, (a, dt) in host.items():
            manifest["arrays"][k] = {"shape": list(a.shape), "dtype": dt,
                                     "sha256": _sha(a)}
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def available_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: Optional[int] = None,
                verify: bool = True,
                key_aliases: Optional[List[Tuple[str, str]]] = None
                ) -> Tuple[Any, int, Dict]:
        """Load into the structure of ``target_tree``: every leaf comes
        back as a new tensor with the target leaf's shape (checked),
        dtype and device (seeds stored as uint32 by the reference load
        into the port's int64 seed leaves).

        ``key_aliases``: (regex, replacement) pairs tried on target keys
        the checkpoint lacks, mapping them onto legacy stored keys;
        defaults to ``LEGACY_KEY_ALIASES``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        arrays = {}
        for k, info in manifest["arrays"].items():
            v = data[k]
            if verify and _sha(v) != info["sha256"]:
                raise IOError(f"checksum mismatch for {k} at step {step}")
            arrays[k] = (v, info["dtype"])
        flat_target = dict(tree_lib.leaves_with_path(target_tree))
        missing = set(flat_target) - set(arrays)
        aliases = LEGACY_KEY_ALIASES if key_aliases is None else key_aliases
        for key in sorted(missing):
            for pat, repl in aliases:
                legacy = re.sub(pat, repl, key)
                if legacy != key and legacy in arrays:
                    arrays[key] = arrays[legacy]
                    missing.discard(key)
                    break
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")

        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            v, dt = arrays[key]
            if tuple(v.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: stored shape {tuple(v.shape)} != "
                                 f"target {tuple(leaf.shape)}")
            if dt == _BF16:
                t = torch.from_numpy(v.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                if v.dtype == np.uint32:           # reference seed words
                    v = v.astype(np.int64)
                t = torch.from_numpy(v.copy())   # 0-d stays 0-d
            return t.to(device=leaf.device, dtype=leaf.dtype)
        tree = tree_lib.map_with_path(load, target_tree)
        return tree, step, manifest.get("metadata", {})
