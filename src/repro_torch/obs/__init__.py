"""repro_torch.obs: metrics and request-trace telemetry for the port's
serving and training stacks (port of ``repro/obs``; docs/observability.md).

``Obs`` is the bundle the engines and the trainer thread through: one
``Registry`` (counters / gauges / histograms, the backing store of the
engines' ``stats()``), one ``TraceStore`` (per-request enqueue → admit →
first-token → retire timelines), a ``Profiler`` (per-dispatch roofline
fractions against a ``HardwareSpec``), an optional step-driven JSONL
``Emitter`` (``launch/serve.py --metrics-out``) and an optional
``SloWatchdog``.

``enabled=False`` turns the layer into its cheap skeleton: counters and
gauges stay live (they ARE ``stats()``), but traces, histograms, emitter
ticks, profiler spans, the numerics capture and the quantized pool's
scale reads are skipped; the engines guard those sites on
``obs.enabled``.

Left out: ``aot_compile`` (``obs/prof.py``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .emit import Emitter, validate_jsonl, validate_line
from .health import HealthPlane, ShadowOracle
from .metrics import (BYTES_BUCKETS, RATIO_BUCKETS, SECONDS_BUCKETS,
                      Counter, Gauge, Histogram, Registry, ScopedRegistry,
                      prometheus_text)
from .prof import DispatchCost, Profiler, ScopedProfiler, resolve_hardware
from .slo import Rule, SloWatchdog, default_rules
from .trace import RequestTrace, TraceStore

__all__ = ["Obs", "Registry", "ScopedRegistry", "Counter", "Gauge",
           "Histogram", "RequestTrace", "TraceStore", "Emitter",
           "validate_line", "validate_jsonl", "SECONDS_BUCKETS",
           "BYTES_BUCKETS", "RATIO_BUCKETS", "Profiler", "ScopedProfiler",
           "DispatchCost", "resolve_hardware",
           "prometheus_text", "HealthPlane", "ShadowOracle", "Rule",
           "SloWatchdog", "default_rules"]


class Obs:
    """Registry + traces + optional emitter on one rebased monotonic clock."""

    def __init__(self, *, enabled: bool = True,
                 emit_path: Optional[str] = None,
                 emit_callback: Optional[Callable[[Dict], None]] = None,
                 emit_every: int = 10,
                 hardware=None, slo: Optional[SloWatchdog] = None):
        self.enabled = bool(enabled)
        self.registry = Registry()
        self.traces = TraceStore()
        # dispatch-level roofline attribution (obs/prof.py): engines
        # register each dispatch's counts and stamp it after its host
        # read; disabled obs keeps the profiler object (wiring stays
        # uniform) but every on_dispatch is a no-op.  ``hardware`` is a
        # roofline.HardwareSpec; None detects the engine's device.
        self.profiler = Profiler(self.registry, hardware=hardware,
                                 enabled=self.enabled)
        self._t0 = time.perf_counter()
        self._labels: Dict[str, str] = {}
        self._owns_emitter = True
        # SLO watchdog (obs/slo.py): bound to the registry so fired
        # alerts bump labelled slo.alerts counters; with an emitter it
        # evaluates on every snapshot flush (alerts become JSONL lines),
        # without one it runs on the same emit_every tick cadence.
        self.slo = slo
        self._slo_ticks = 0
        self._slo_every = max(1, int(emit_every))
        if slo is not None:
            slo.bind(self.registry)
        self.emitter: Optional[Emitter] = None
        if emit_path is not None or emit_callback is not None:
            self.emitter = Emitter(self.registry, self.traces,
                                   path=emit_path, callback=emit_callback,
                                   every=emit_every, clock=self.now,
                                   watchdog=slo)

    def scoped(self, **labels) -> "Obs":
        """A labelled view sharing this Obs's clock, trace store, emitter,
        and dispatch log — the handle each fleet replica's engine gets.
        Metrics created through the view carry the labels (``replica=r0``),
        traces stamp their ``replica`` field, dispatch kinds are prefixed
        per scope, and ``close()`` on a view only flushes (the owning Obs
        closes the shared emitter exactly once — see docs/observability.md).
        """
        view = Obs.__new__(Obs)
        view.enabled = self.enabled
        view.registry = self.registry.scoped(**labels)
        view.traces = self.traces
        view.profiler = ScopedProfiler(self.profiler, labels)
        view._t0 = self._t0
        merged = dict(self._labels)
        merged.update({k: str(v) for k, v in labels.items()})
        view._labels = merged
        view._owns_emitter = False
        view.emitter = self.emitter
        view.slo = self.slo
        view._slo_ticks = 0
        view._slo_every = self._slo_every
        return view

    def now(self) -> float:
        """Seconds on the obs clock (monotonic, 0 at Obs creation)."""
        return time.perf_counter() - self._t0

    def rebase(self, t_perf: float) -> float:
        """A raw ``time.perf_counter()`` stamp on the obs clock — engines
        time spans on perf_counter and rebase the marks they hand to
        traces, so every trace shares one timeline."""
        return t_perf - self._t0

    # -- trace lifecycle (no-ops when disabled) ---------------------------
    def trace_start(self, id: int, order: int, prompt_len: int,
                    enqueue_s: float) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        return self.traces.start(id, order, prompt_len, enqueue_s,
                                 replica=self._labels.get("replica"))

    def trace_finish(self, trace: Optional[RequestTrace]) -> None:
        """Validate + complete a trace and fold its derived latencies into
        the standard histograms (one definition of TTFT/TPOT everywhere)."""
        if trace is None or not self.enabled:
            return
        self.traces.finish(trace)
        reg = self.registry
        # unserved terminals (rejected/cancelled in queue, ...) lack some
        # marks; fold only the spans their timeline defines
        for name, v in (("trace.queue_s", trace.queue_s),
                        ("trace.ttft_s", trace.ttft_s),
                        ("trace.latency_s", trace.latency_s),
                        ("trace.tpot_s", trace.tpot_s)):
            if v is not None:
                reg.histogram(name).observe(v)

    # -- emitter cadence --------------------------------------------------
    def tick(self) -> None:
        if not self.enabled:
            return
        if self.emitter is not None:
            self.emitter.tick()
            return
        # no emitter: the owning Obs still drives the SLO watchdog on the
        # same cadence (scoped views defer to their owner's ticks)
        if self.slo is not None and self._owns_emitter:
            self._slo_ticks += 1
            if self._slo_ticks % self._slo_every == 0:
                self._slo_observe()

    def baseline(self) -> None:
        """Emit/observe one snapshot NOW — an engine calls this after
        registering its counters so rate/ratio SLO rules measure their
        first window from a true zero baseline.  Without it, any counter
        activity before the first ``emit_every`` tick (e.g. a NaN-guard
        trip in the opening dispatches) lands inside the skipped first
        snapshot and can never fire the anomaly-burst rule."""
        if not self.enabled:
            return
        if self.emitter is not None:
            self.emitter.flush()
        elif self.slo is not None and self._owns_emitter:
            self._slo_observe()

    def _slo_observe(self) -> None:
        snap = {"type": "snapshot", "seq": None, "t_s": self.now()}
        snap.update(self.registry.snapshot())
        self.slo.observe(snap)

    def close(self) -> None:
        """Flush + close the emitter.  A scoped view only flushes — the
        shared emitter belongs to the base Obs, and a replica draining must
        not cut off its fleet-mates' telemetry."""
        if self.emitter is None:
            # emitterless SLO runs still get a final evaluation so the
            # last inter-snapshot window is not silently dropped
            if self.slo is not None and self._owns_emitter:
                self._slo_observe()
            return
        if self._owns_emitter:
            self.emitter.close()
        else:
            self.emitter.flush()

    # -- human-readable exit summary (launch/serve.py) --------------------
    def summary(self) -> str:
        lines = ["metric                              value"]
        snap = self.registry.snapshot()
        for section in ("counters", "gauges"):
            for name, v in snap[section].items():
                val = f"{v:.6g}" if isinstance(v, float) else str(v)
                lines.append(f"{name:<35} {val}")
        for name, h in snap["histograms"].items():
            if not h["count"]:
                continue
            lines.append(
                f"{name:<35} n={h['count']} p50={h['p50']:.4g} "
                f"p99={h['p99']:.4g} max={h['max']:.4g}")
        return "\n".join(lines)
