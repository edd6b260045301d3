"""Dispatch-level roofline attribution for the serving engines (port of
``repro/obs/prof.py``).

Every engine dispatch kind (a prefill page bucket, ``decode_chunk``, the
batch engine's prefill and decode-loop shapes) carries a FLOP and byte
count, and every dispatch, timed between host syncs the engine already
makes, then derives

    achieved FLOP/s   = flops / dt
    achieved bytes/s  = bytes_accessed / dt
    roofline fraction = bound_s / dt,   bound_s = max(flops / peak_FLOP/s,
                                                      bytes / HBM_bw)

against a ``roofline.analysis.HardwareSpec`` (``h100`` on an H100,
``host-cpu`` on the CPU).  Everything lands in the owning ``Obs``
registry (``prof.flops_per_s{dispatch=...}``, ``prof.bytes_per_s{...}``,
``prof.roofline_frac{...}`` histograms); the profiler also keeps a
bounded dispatch log of (kind, start, end, fraction) marks on the obs
clock and per-dispatch samples of watched gauges, which
``obs/chrometrace.py`` renders.

The counts differ from ``repro``'s by convention.  ``repro`` prices a
dispatch from XLA's ``cost_analysis()`` of the compiled executable: every
operation and operand touch the program makes, padding and all.  The port
has no compiled program to ask, so the engines pass counts from
``roofline/analysis.py`` to ``register(kind, flops, bytes_accessed)``:

* FLOPs: the dispatch's true tokens x (``model_flops_per_token`` +
  ``seq_mixer_flops_per_token`` at their positions);
* bytes: the weights as served (``serving_weight_bytes``: the baked
  planes of the lane in use, scales included, and every parameter no plane
  replaces) once a forward pass, and the KV bytes the attention layers
  read and write.

These are the least work the dispatch must do, so a fraction above 1
means a wrong count, where ``repro``'s XLA counts could sit above the
work.  The dispatch's cost is registered anew at each dispatch (its
tokens and positions vary); the histograms accumulate over a kind.

Left out: ``aot_compile`` (ahead-of-time compilation of a ``jax.jit``
function, whose executable carried the cost).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..roofline.analysis import (HARDWARE_PRESETS, HardwareSpec,
                                 detect_hardware)
from .metrics import Gauge, Registry, flat_name

# Log-spaced FLOP/s + bytes/s buckets covering host CPUs through one card.
RATE_BUCKETS = tuple(float(10 ** e) for e in range(6, 16))     # 1e6..1e15
# Roofline fractions: log-spaced below 1.0, the overflow bucket catches
# > 1.0 (a count above the work).
FRAC_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5,
                0.75, 1.0)


@dataclasses.dataclass(frozen=True)
class DispatchCost:
    """FLOP and byte counts of one dispatch kind on the profiler's spec.

    ``bound_s`` is the roofline-limited runtime, the larger of the compute
    and memory terms, and ``bound`` names which side limits."""
    kind: str
    flops: float
    bytes_accessed: float
    t_compute_s: float
    t_memory_s: float

    @property
    def bound_s(self) -> float:
        return max(self.t_compute_s, self.t_memory_s)

    @property
    def bound(self) -> str:
        return ("compute" if self.t_compute_s >= self.t_memory_s
                else "memory")

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per HBM byte)."""
        return self.flops / max(self.bytes_accessed, 1.0)


class Profiler:
    """Per-dispatch roofline accounting into an ``obs`` Registry.

    ``register(kind, flops, bytes_accessed)`` returns the
    ``DispatchCost`` of one dispatch; ``on_dispatch(cost, t0, t1)`` records
    the dispatch with marks on the obs clock.  The continuous engine's
    kinds are ``prefill_{n}p`` per page bucket and ``decode_chunk``; the
    batch engine's ``prefill_b{B}_s{S}`` and ``decode_loop_s{steps}_b{B}``.
    ``hardware`` None detects the card (``bind_device`` re-detects it for
    the engine's device).
    """

    def __init__(self, registry: Registry, *,
                 hardware: Optional[HardwareSpec] = None,
                 enabled: bool = True, keep_events: int = 100_000):
        self.registry = registry
        self._auto = hardware is None
        self.spec = hardware if hardware is not None else detect_hardware()
        self.enabled = bool(enabled)
        self.costs: Dict[str, DispatchCost] = {}
        # (kind, t_start_s, t_end_s, roofline_frac|None) on the obs clock
        self.events: deque = deque(maxlen=int(keep_events))
        # gauge samples taken at each dispatch end: name -> [(t_s, value)]
        self.samples: Dict[str, List[Tuple[float, float]]] = {}
        self._watched: List[Tuple[str, Gauge]] = []
        self._hists: Dict[str, Tuple] = {}

    def bind_device(self, device) -> None:
        """Price against ``device``'s preset where no spec was given."""
        if self._auto:
            self.spec = detect_hardware(device)

    # -- wiring -----------------------------------------------------------
    def register(self, kind: str, flops: float,
                 bytes_accessed: float) -> DispatchCost:
        """The cost of a dispatch of ``kind`` doing ``flops`` operations
        and moving ``bytes_accessed`` bytes; the kind's histograms are
        made at its first registration."""
        flops, nbytes = float(flops), float(bytes_accessed)
        cost = DispatchCost(
            kind=kind, flops=flops, bytes_accessed=nbytes,
            t_compute_s=flops / self.spec.peak_flops,
            t_memory_s=nbytes / self.spec.hbm_bw)
        self.costs[kind] = cost
        if kind not in self._hists:
            reg = self.registry
            self._hists[kind] = (
                reg.histogram("prof.flops_per_s", bounds=RATE_BUCKETS,
                              dispatch=kind),
                reg.histogram("prof.bytes_per_s", bounds=RATE_BUCKETS,
                              dispatch=kind),
                reg.histogram("prof.roofline_frac", bounds=FRAC_BUCKETS,
                              dispatch=kind),
            )
        return cost

    def watch(self, name: str, **labels) -> None:
        """Sample a registry gauge at every dispatch end (Chrome-trace
        counter tracks: queue depth, free pages, tokens in flight)."""
        if not self.enabled:
            return
        gauge = self.registry.gauge(name, **labels)
        key = flat_name(name, tuple(sorted(
            (k, str(v)) for k, v in labels.items())))
        if all(k != key for k, _ in self._watched):
            self._watched.append((key, gauge))
            self.samples.setdefault(key, [])

    # -- hot path (once per dispatch) -------------------------------------
    def on_dispatch(self, cost: Optional[DispatchCost], t0_s: float,
                    t1_s: float) -> None:
        """Record one dispatch: ``t0_s`` / ``t1_s`` are obs-clock marks,
        ``t1_s`` stamped after the host read that ends the dispatch.
        ``cost`` None still logs the timeline event, uncosted."""
        if not self.enabled:
            return
        frac = None
        if cost is not None:
            dt = max(t1_s - t0_s, 1e-9)
            h_flops, h_bytes, h_frac = self._hists[cost.kind]
            h_flops.observe(cost.flops / dt)
            h_bytes.observe(cost.bytes_accessed / dt)
            frac = cost.bound_s / dt
            h_frac.observe(frac)
            kind = cost.kind
        else:
            kind = "uncosted"
        self.events.append((kind, t0_s, t1_s, frac))
        for key, gauge in self._watched:
            self.samples[key].append((t1_s, gauge.value))

    # -- views ------------------------------------------------------------
    def summary(self) -> Dict[str, Dict]:
        """Per dispatch kind, for ``stats()``: the last dispatch's counts,
        the dispatch count, mean achieved FLOP/s and bytes/s, and the
        roofline fraction (mean, p50, max) against ``self.spec``."""
        out: Dict[str, Dict] = {}
        for kind, cost in sorted(self.costs.items()):
            h_flops, h_bytes, h_frac = self._hists[kind]
            n = h_frac.count
            out[kind] = {
                "dispatches": n,
                "flops": cost.flops,
                "bytes_accessed": cost.bytes_accessed,
                "intensity_flops_per_byte": cost.intensity,
                "bound": cost.bound,
                "bound_s": cost.bound_s,
                "achieved_flops_per_s": (h_flops.sum / n) if n else None,
                "achieved_bytes_per_s": (h_bytes.sum / n) if n else None,
                "roofline_frac": (h_frac.sum / n) if n else None,
                "roofline_frac_p50": h_frac.percentile(50),
                "roofline_frac_max": h_frac.max,
            }
        return out


class ScopedProfiler:
    """Label-scoped facade over a shared ``Profiler`` (``Obs.scoped``): the
    view prefixes its dispatch kinds (``r0:decode_chunk``) and labels its
    watched gauges; ``summary()`` filters to this scope's kinds."""

    def __init__(self, base: Profiler, labels: Dict[str, str]):
        self.base = base
        self.labels = {k: str(v) for k, v in labels.items()}
        self.prefix = ",".join(v for _, v in sorted(self.labels.items()))

    @property
    def spec(self) -> HardwareSpec:
        return self.base.spec

    @property
    def enabled(self) -> bool:
        return self.base.enabled

    @property
    def events(self):
        return self.base.events

    @property
    def costs(self):
        return self.base.costs

    @property
    def samples(self):
        return self.base.samples

    def _kind(self, kind: str) -> str:
        return f"{self.prefix}:{kind}" if self.prefix else kind

    def bind_device(self, device) -> None:
        self.base.bind_device(device)

    def register(self, kind: str, flops: float,
                 bytes_accessed: float) -> DispatchCost:
        return self.base.register(self._kind(kind), flops, bytes_accessed)

    def watch(self, name: str, **labels) -> None:
        merged = dict(self.labels)
        merged.update({k: str(v) for k, v in labels.items()})
        self.base.watch(name, **merged)

    def on_dispatch(self, cost: Optional[DispatchCost], t0_s: float,
                    t1_s: float) -> None:
        self.base.on_dispatch(cost, t0_s, t1_s)

    def summary(self) -> Dict[str, Dict]:
        if not self.prefix:
            return self.base.summary()
        pre = self.prefix + ":"
        return {k[len(pre):]: v for k, v in self.base.summary().items()
                if k.startswith(pre)}


def resolve_hardware(name: Optional[str]) -> Optional[HardwareSpec]:
    """CLI helper: a preset by name; ``None`` / "auto" gives None (the
    profiler then detects the engine's device)."""
    if name is None or name == "auto":
        return None
    try:
        return HARDWARE_PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown hardware preset {name!r}: expected one "
                         f"of {sorted(HARDWARE_PRESETS)} or 'auto'")
