"""Fault-tolerant training loop. Port of ``repro.train.trainer``.

Wires together the model step (``launch/steps.py``), AdamW, the
schedule, the sharded data loader, the checkpoint manager
(atomic/async/auto-resume), the straggler watchdog and, with a mesh,
compressed cross-pod data parallelism (``distributed/collectives``).

Failure model: the process can die at ANY step (the ``crash_at`` hook
raises after that step's save would have happened); a restarted Trainer
resumes from the latest committed checkpoint and, because the data
stream is a function of (seed, step, shard), replays the same batches.

Runs on ``TrainerConfig.device`` (the card unless told otherwise).
``Trainer(mesh=...)`` with ``compress_dp`` runs each step as grad step ->
``collectives.compressed_pod_mean`` over the mesh's ``pod`` axis ->
AdamW, carrying the error-feedback state across steps (f32, the size of
the params; not checkpointed, as in the reference, so a resumed run
restarts it at zero). The gradients are the whole batch's, replicated
over the pods, as in the reference's single-controller trainer. Without
a mesh, ``compress_dp`` is ignored and training is plain, as in the
reference; a mesh without ``compress_dp`` trains plainly too.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import collectives
from repro_torch.data import synth
from repro_torch.data.loader import ShardedLoader, device_batch
from repro_torch.ft.straggler import StragglerWatchdog
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer as model_lib
from repro_torch.optim import adamw, schedule
from repro_torch.optim import compression as comp_lib


@dataclass
class TrainerConfig:
    num_steps: int = 100
    batch: int = 8
    seq: int = 64
    seed: int = 0
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    hyper: step_lib.TrainHyper = field(default_factory=step_lib.TrainHyper)
    compress_dp: bool = False       # needs a mesh; ignored without one
    compression: comp_lib.CompressionConfig = field(
        default_factory=comp_lib.CompressionConfig)
    device: str = "cuda"


class CrashInjected(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, mesh=None,
                 crash_at: Optional[int] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.crash_at = crash_at
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.watchdog = StragglerWatchdog(n_hosts=1)
        self.metrics_log: list = []
        self._build()

    # -------------- setup --------------

    def _build(self):
        self.params = model_lib.requires_grad(model_lib.init(
            self.cfg, seed=self.tcfg.seed, device=self.tcfg.device))
        self.opt_state = adamw.init(self.params)
        self.step = 0
        if self.tcfg.compress_dp and self.mesh is not None:
            if self.cfg.attn_impl == "srf" and self.cfg.srf.seeded:
                raise ValueError("compress_dp: seeded SRF's integer seeds "
                                 "have no gradient to compress")
            self.err = comp_lib.init_error(self.params)
            self._step_fn = self._compressed_step()
        else:
            self.err = None
            self._step_fn = step_lib.make_train_step(self.cfg,
                                                     self.tcfg.hyper)

        def make_batch(step, shard):
            return synth.full_batch(self.cfg, self.tcfg.batch,
                                    self.tcfg.seq, step,
                                    seed=self.tcfg.seed, shard=shard)
        self.loader = ShardedLoader(make_batch)

    def _compressed_step(self):
        """grad step -> compressed pod mean -> AdamW; the error state is
        carried on ``self.err``."""
        hyper = self.tcfg.hyper
        grad_fn = step_lib.make_grad_step(self.cfg, hyper.aux_weight)

        def cstep(params, opt_state, step_idx, batch):
            grads, metrics = grad_fn(params, batch)
            grads, self.err = collectives.compressed_pod_mean(
                grads, self.err, self.mesh, self.tcfg.compression,
                step=step_idx)
            lr = schedule.warmup_cosine(step_idx, hyper.lr, hyper.warmup,
                                        hyper.total_steps,
                                        device=metrics["loss"].device)
            params, opt_state, stats = adamw.update(grads, opt_state,
                                                    params, lr, hyper.adam)
            return params, opt_state, {**metrics, **stats, "lr": lr}
        return cstep

    # -------------- resume --------------

    def try_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        restored, step, _ = self.ckpt.restore(state)
        self.params = model_lib.requires_grad(restored["params"])
        self.opt_state = restored["opt"]
        self.step = step
        self.loader.reset(step)
        return True

    # -------------- loop --------------

    def _state(self) -> Dict:
        return {"params": self.params, "opt": self.opt_state}

    def train(self) -> Dict:
        it = iter(self.loader.reset(self.step))
        t_last = time.time()
        while self.step < self.tcfg.num_steps:
            step_i, host_batch = next(it)
            assert step_i == self.step, (step_i, self.step)
            batch = device_batch(host_batch, self.tcfg.device)
            self.params, self.opt_state, m = self._step_fn(
                self.params, self.opt_state, self.step, batch)
            self.step += 1
            now = time.time()
            self.watchdog.record(0, self.step, now - t_last)
            t_last = now
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.num_steps:
                rec = {"step": self.step,
                       **{k: float(v) for k, v in m.items()}}
                self.metrics_log.append(rec)
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step, self._state(),
                               metadata={"loss": float(m["loss"])})
            if self.crash_at is not None and self.step == self.crash_at:
                self.loader.stop()
                raise CrashInjected(f"injected crash at step {self.step}")
        self.ckpt.save(self.step, self._state(), metadata={"final": True},
                       blocking=True)
        self.ckpt.wait()
        self.loader.stop()
        return {"final_step": self.step, "log": self.metrics_log}
