"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

* Resume from the newest intact checkpoint (atomic writes: a preemption
  mid-save cannot corrupt it).
* Periodic checkpoints (every ``ckpt_every`` steps, and at the end unless
  the last periodic one holds that step; none with ``ckpt_every=0``),
  and one at the next step boundary after SIGTERM (preemption), then
  exit.
* Non-finite steps are skipped inside the step (``train_step.py``) and
  counted here.
* A heartbeat file in the workdir; ``heartbeat_age`` gives its age for a
  watchdog.
* Step-indexed data: nothing of the pipeline to restore.

Telemetry rides the same ``obs`` plane the serving stack uses: pass
``obs=`` (``repro_torch.obs.Obs``, or let the trainer build one) and every
step lands in its registry: ``train.steps``, ``train.tokens``,
``train.skipped_steps`` (counters), ``train.step_s`` (histogram: a step's
wall time, the device synchronised), ``train.loss``, ``train.grad_norm``
and ``train.tokens_per_s`` (gauges).  With ``obs.enabled`` the loss and
gradient norm are read every step, as ``repro``'s trainer does (else at
logging steps only); with an emitter attached the snapshots stream to
JSONL on its cadence (``obs.tick()`` once a step).  ``registry`` is
``obs.registry``.  The heartbeat file keeps its own format.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Callable, Dict, Optional

from . import checkpoint as ckpt
from . import train_step as ts
from ..device import resolve_device, synchronize
from ..obs import Obs
from ..optim import adamw, schedule


class Trainer:
    def __init__(self, cfg, opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                 workdir: str, data_fn: Callable, total_steps: int = 100,
                 ckpt_every: int = 50, accum: int = 1, log_every: int = 10,
                 compress_grads: bool = False, bayesian_mode: bool = False,
                 lr_schedule=None,
                 obs: Optional[Obs] = None, device=None, seed: int = 0):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.workdir = workdir
        self.data_fn = data_fn
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.device = resolve_device(device)
        self.seed = seed
        self.obs = obs if obs is not None else Obs()
        self.registry = reg = self.obs.registry
        self._c_steps = reg.counter("train.steps")
        self._c_tokens = reg.counter("train.tokens")
        self._c_skipped = reg.counter("train.skipped_steps")
        self._h_step = reg.histogram("train.step_s")
        self._g_loss = reg.gauge("train.loss")
        self._g_gnorm = reg.gauge("train.grad_norm")
        self._g_tps = reg.gauge("train.tokens_per_s")
        os.makedirs(workdir, exist_ok=True)
        peak_lr = self.opt_cfg.lr           # not self: no reference cycle
        lr_fn = lr_schedule or (
            lambda step: schedule.warmup_cosine(
                step, peak_lr=peak_lr,
                warmup_steps=max(total_steps // 20, 1),
                total_steps=total_steps))
        self.step_fn = ts.make_train_step(cfg, self.opt_cfg, accum=accum,
                                          lr_schedule=lr_fn,
                                          compress_grads=compress_grads,
                                          bayesian_mode=bayesian_mode)
        self.compress_grads = compress_grads
        self.bayesian_mode = bayesian_mode
        self._state = None
        self._preempted = False
        self.history: list = []

    # -- fault-tolerance plumbing ------------------------------------------
    def _heartbeat(self, step: int):
        # "time" is for humans; ages use "mono" (CLOCK_MONOTONIC, the same
        # across processes on one host and immune to clock steps)
        hb = {"step": step, "time": time.time(), "mono": time.perf_counter()}
        with open(os.path.join(self.workdir, "heartbeat.json"), "w") as f:
            json.dump(hb, f)

    @staticmethod
    def heartbeat_age(workdir: str) -> float:
        """Seconds since the last heartbeat (inf without one)."""
        path = os.path.join(workdir, "heartbeat.json")
        if not os.path.exists(path):
            return float("inf")
        with open(path) as f:
            hb = json.load(f)
        if "mono" in hb:
            return time.perf_counter() - hb["mono"]
        return time.time() - hb["time"]

    def _install_preemption_handler(self):
        """Install the SIGTERM handler; returns the one it replaced (None
        off the main thread, where none is installed)."""
        def handler(signum, frame):
            self._preempted = True          # checkpoint at next step boundary
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None                     # not the main thread (tests)

    # -- the loop -----------------------------------------------------------
    def init_or_restore(self) -> Dict:
        state = ts.init_state(self.cfg, self.opt_cfg, seed=self.seed,
                              device=self.device,
                              compress_grads=self.compress_grads,
                              bayesian_mode=self.bayesian_mode)
        try:
            state, step = ckpt.restore(os.path.join(self.workdir, "ckpt"),
                                       state)
            print(f"[trainer] resumed from step {step}", flush=True)
        except FileNotFoundError:
            pass
        self._state = state
        return state

    def run(self) -> Dict:
        """Train to ``total_steps``; the SIGTERM handler is installed for
        the run and the previous one restored after it (so a finished
        trainer, and its state, is not kept alive by the handler)."""
        previous = self._install_preemption_handler()
        try:
            return self._run()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self) -> Dict:
        if self._state is None:
            self.init_or_restore()
        state = self._state
        start = int(state["step"])
        ckpt_dir = os.path.join(self.workdir, "ckpt")
        skipped0 = int(state["skipped"])
        saved = None                        # the step last checkpointed
        for step in range(start, self.total_steps):
            t0 = time.perf_counter()
            batch = {k: v.to(self.device) for k, v in
                     self.data_fn(step).items()}
            state, metrics = self.step_fn(state, batch)
            synchronize(self.device)
            dt = time.perf_counter() - t0
            ntok = int(batch["tokens"].numel())
            self._c_steps.inc()
            self._c_tokens.inc(ntok)
            self._h_step.observe(dt)
            self._g_tps.set(ntok / max(dt, 1e-9))
            log = (step + 1) % self.log_every == 0 or step == start
            if log or self.obs.enabled:
                self._g_loss.set(float(metrics["loss"]))
                self._g_gnorm.set(float(metrics["grad_norm"]))
                skipped = int(state["skipped"])
                if skipped > skipped0:
                    self._c_skipped.inc(skipped - skipped0)
                    skipped0 = skipped
            if log:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step + 1, step_s=dt)
                self.history.append(m)
                print(f"[trainer] step {step + 1} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} skipped={skipped}",
                      flush=True)
            self._heartbeat(step + 1)
            self.obs.tick()                # the emitter rides the step cadence
            if self._preempted or (self.ckpt_every
                                   and (step + 1) % self.ckpt_every == 0):
                ckpt.save(ckpt_dir, step + 1, state)
                saved = step + 1
                if self._preempted:
                    print("[trainer] preemption checkpoint saved; exiting",
                          flush=True)
                    break
        skipped = int(state["skipped"])
        if skipped > skipped0:
            self._c_skipped.inc(skipped - skipped0)
        if self.ckpt_every and saved != int(state["step"]):
            ckpt.save(ckpt_dir, int(state["step"]), state)
        self._state = state
        return state
