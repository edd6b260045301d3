"""A serving cell: open-loop clients against
``repro_torch.serve.engine.ContinuousEngine``, timed from the client's side.

The benchmark drives the engine through its public calls (``submit``,
``step``, ``result``) in one thread and reads each request's progress
after every step: tokens a request has when ``step`` returns are
delivered at that moment.  In-flight progress is read from the
scheduler's running slots (``engine.scheduler.running``: the engine has
no per-request delivery hook).  Set-up, the ramp and the window run on
one clock; the window's numbers come from every request and token that
falls in it.

A traced run profiles a fixed slice of the window (the mix's
``trace``), between steps, and keeps the engine's counters at both ends
of it and the work each step asked of the kernels: every prefill's true
prompt length, and for every decode step the key count of each live
slot.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import devtrace, model, traffic

COUNTERS = ("prefill_s", "decode_s", "prompt_tokens", "tokens",
            "engine.decode_steps", "engine.prefills")


@dataclasses.dataclass
class Track:
    """One request as its client sees it."""
    order: int
    prompt: np.ndarray
    budget: int
    submit_t: float
    seen: int = 0
    deliveries: List = dataclasses.field(default_factory=list)
    end_t: Optional[float] = None
    status: Optional[str] = None
    tokens: Optional[List[int]] = None


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def host_probe() -> float:
    """Seconds of a fixed piece of pure-Python work: how fast this host ran
    when it was read (a diagnostic on standard error)."""
    t = time.perf_counter()
    x = 0
    for i in range(2_000_000):
        x += i & 7
    return time.perf_counter() - t


def counters(engine) -> Dict[str, float]:
    reg = engine.obs.registry
    out = {n: float(reg.value(n)) for n in COUNTERS}
    occ = reg.histogram("sched.slot_occupancy")
    out["occupancy_sum"], out["occupancy_n"] = float(occ.sum), float(occ.count)
    return out


def build_engine(arch, params, mix: Dict, device):
    from repro_torch.quant.codec import QuantPolicy
    from repro_torch.serve.engine import ContinuousEngine
    e = dict(mix["engine"])
    kv = e.pop("kv_dtype")
    return ContinuousEngine(arch, params, quant=QuantPolicy(kv_dtype=kv),
                            device=device, **e)


class Loop:
    """The clients, the engine and the client-side record of every
    request."""

    def __init__(self, engine, mix: Dict, reqs: List, seed: int,
                 span: float):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.engine = engine
        self.reqs = reqs
        self.next = 0
        self.tracks: List[Track] = []
        self.live: Dict[int, Track] = {}
        self.first = traffic.first_budgets(mix, reqs)
        self.arrivals = traffic.arrival_times(mix, seed, span)
        self.t0: Optional[float] = None        # the ramp's start
        self.k = 0                             # arrivals sent
        self.late = 0.0          # how late the loop sent, at most
        self.steps: Optional[List] = None       # the slice's work, or None

    def _submit(self, t: float) -> None:
        i = self.next % len(self.reqs)
        r = self.reqs[i]
        budget = r.max_new_tokens
        if self.next < len(self.first):
            budget = self.first[self.next]
        self.next += 1
        order = self.engine.submit(self.Request(r.prompt, budget, id=i))
        tr = Track(order, r.prompt, budget, t)
        self.tracks.append(tr)
        self.live[order] = tr
        res = self.engine.result(order, pop=True)   # refused at once
        if res is not None:
            self._end(tr, res, t)

    def _due(self) -> float:
        if self.k < len(self.arrivals):
            return self.t0 + float(self.arrivals[self.k])
        return float("inf")

    def submit_due(self, now: float) -> None:
        if self.t0 is None:
            for _ in self.first:               # the population at the start
                self._submit(now)
            self.t0 = now
        while self._due() <= now:
            # each request is timed from when it was due
            due = self._due()
            self.late = max(self.late, now - due)
            self._submit(due)
            self.k += 1

    def _end(self, tr: Track, res: Dict, t: float) -> None:
        tr.end_t, tr.status, tr.tokens = t, res["status"], list(res["tokens"])
        del self.live[tr.order]

    def observe(self, t: float) -> None:
        """Read every live request's progress after a step ending at
        ``t``; in a traced slice, keep the step's work."""
        running = {s.order: s for s in self.engine.scheduler.running}
        prefills, decode = [], []
        for tr in list(self.live.values()):
            res = self.engine.result(tr.order, pop=True)
            if res is not None:
                count = len(res["tokens"])
            elif tr.order in running:
                count = len(running[tr.order].tokens)
            else:
                count = 0
            new = count - tr.seen
            if new > 0:
                tr.deliveries.append((t, new))
                S = len(tr.prompt)
                if tr.seen == 0:
                    prefills.append(S)
                j0 = max(tr.seen, 1)
                if count > j0:
                    # decode token j attends to S + j keys
                    decode.append((S + j0, count - j0))
                tr.seen = count
            if res is not None:
                self._end(tr, res, t)
        if self.steps is not None:
            self.steps.append({"prefills": prefills, "decode": decode})

    def sleep_until_due(self, until: float) -> None:
        if self.t0 is not None:
            due = min(self._due(), until)
            time.sleep(max(0.0, due - time.perf_counter()))


def warm_up(engine, reqs: List) -> None:
    """One request through a prefill and a decode chunk before the ramp,
    so that first-call work lands in set-up; its result is dropped."""
    from repro_torch.serve.engine import Request
    order = engine.submit(Request(reqs[0].prompt, 2, id=-1))
    while engine.result(order, pop=True) is None:
        engine.step()


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, clock0: float, sync) -> Dict:
    """One run of a serving cell; returns the record the metric readers
    and the check read."""
    arch = model.arch_config(cfg)
    weights = model.make_weights(cfg, seed, device)
    params = model.build_program_model(arch, weights, device)
    del weights
    sync()
    log(f"weights at {time.perf_counter() - clock0:.2f} s")
    engine = build_engine(arch, params, mix, device)
    sync()
    log(f"engine at {time.perf_counter() - clock0:.2f} s")
    prefix = cfg["frontend"]["num_patches"]
    reqs = traffic.requests(mix, seed, cfg["vocab_size"], prefix)
    warm_up(engine, reqs)
    ramp_s = float(mix.get("ramp_s", 0.0))
    loop = Loop(engine, mix, reqs, seed, ramp_s + seconds)
    if trace:
        devtrace.warm(device.type)     # the profiler's own start-up
    sync()
    log(f"ramp from {time.perf_counter() - clock0:.2f} s")
    t_ramp = time.perf_counter()
    t_open = t_ramp + ramp_s
    tr_cfg = mix.get("trace", {})
    t_slice = t_slice_end = t_end = float("inf")
    tracer = None
    slice_data = None
    setup_s = None
    n_steps = 0
    gc_s = [0.0, 0]
    gc_t = [0.0]

    def gc_watch(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t[0]
            gc_s[1] += 1
    gc.callbacks.append(gc_watch)
    while True:
        now = time.perf_counter()
        if setup_s is None and now >= t_open:
            t_open = now
            setup_s = now - clock0
            at_open, steps_open = counters(engine), n_steps
            t_slice = t_open + float(tr_cfg.get("after_s", 0.0))
            t_end = t_open + seconds
        if trace and tracer is None and setup_s is not None and now >= t_slice:
            tracer = Slice(engine, loop, device, sync)
            t_slice_end = tracer.t0 + float(tr_cfg.get("slice_s", 0.0))
        elif tracer is not None and slice_data is None and (
                now >= t_slice_end or now >= t_end):
            slice_data = tracer.stop()
        if now >= t_end:
            break
        spans = tracer is not None and slice_data is None
        with _span("bench.submit", spans):
            loop.submit_due(now)
        with _span("bench.step", spans):
            progress = engine.step()
        n_steps += 1
        t = time.perf_counter()
        with _span("bench.observe", spans):
            loop.observe(t)
        if not progress:
            loop.sleep_until_due(t_end if setup_s is not None else t_open)
    t_close = time.perf_counter()
    sync()
    gc.callbacks.remove(gc_watch)
    c = counters(engine)
    d = {k: c[k] - at_open[k] for k in c}
    log(f"window {t_close - t_open:.2f} s: {len(loop.tracks)} requests "
        f"submitted in all; {n_steps - steps_open} steps, "
        f"{d['engine.prefills']:.0f} prefills in {d['prefill_s']:.2f} s, "
        f"{d['engine.decode_steps']:.0f} decode steps in "
        f"{d['decode_s']:.2f} s; {engine.scheduler.preempted} preempted; "
        f"sent late by at most {loop.late:.3f} s; "
        f"gc {gc_s[1]} runs {gc_s[0]:.3f} s; host probe {host_probe():.4f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    finished = [tr for tr in loop.tracks if tr.end_t is not None
                and t_open <= tr.end_t <= t_close]
    record = {
        "kind": "serve", "cfg": cfg, "mix": mix, "seed": seed,
        "setup_s": setup_s, "t_open": t_open, "t_close": t_close,
        "window_s": t_close - t_open, "tracks": loop.tracks,
        "finished": finished, "slice": slice_data if trace else None,
        "memory_peak_bytes": int(peak),
    }
    # the program's state goes before the reference runs
    del engine, params, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


class Slice:
    """A traced slice: the engine's counters at both ends, the steps' work
    and the device trace (``lib/devtrace.py``), between two steps."""

    def __init__(self, engine, loop: Loop, device, sync):
        self.engine, self.loop, self.sync = engine, loop, sync
        sync()
        self.before = counters(engine)
        loop.steps = []
        self.prof = devtrace.Profiler(device.type)
        self.rf = torch.profiler.record_function(devtrace.SLICE)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        self.sync()
        self.rf.__exit__(None, None, None)
        wall = time.perf_counter() - self.t0
        after = counters(self.engine)
        out = self.prof.stop() or {}
        out.update(wall_s=wall, steps=self.loop.steps,
                   counters={k: after[k] - self.before[k] for k in after})
        self.loop.steps = None
        return out


class _span:
    """``record_function(name)`` while ``on``, else nothing."""

    def __init__(self, name: str, on: bool):
        self.rf = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
