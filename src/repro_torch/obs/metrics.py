"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(port of ``repro/obs/metrics.py``, its whole API).

The paper's co-optimization loop is an accounting exercise — per-stage
pipeline occupancy and resource utilization decide where the next cycle or
byte goes.  This module is the software analogue's ledger: a tiny,
dependency-free registry the serving stack bumps on its hot path.

Design constraints (why this is not a metrics framework):

* **Zero hot-path allocation.**  ``Counter.inc`` / ``Gauge.set`` are one
  float add / store on an object the caller holds a direct reference to;
  registry lookups (dict + tuple key) happen once, at wiring time.  No
  locks (engines are single-threaded by design — the emitter is
  step-driven, not a thread), no string formatting, no deps.
* **Fixed buckets.**  ``Histogram`` counts into immutable bucket bounds
  chosen at creation (log-spaced defaults for seconds/bytes/ratios), so
  ``observe`` is a bisect + two adds.  Raw values are additionally retained
  (bounded) so ``percentile`` can answer exactly — the benchmarks'
  p50/p99 come from here instead of hand-rolled ``np.percentile`` copies.
* **Snapshot/delta.**  ``Registry.snapshot()`` returns a plain JSON-able
  dict (the emitter's line payload); ``delta`` subtracts two snapshots'
  counters for rate windows.

Metric names are dotted strings (``sched.admitted``); labels are optional
keyword pairs that become part of the metric identity
(``counter("sched.deferred", reason="pages")`` and ``reason="budget"`` are
distinct series).  The flattened name is ``name{k=v,...}`` with labels
sorted — one documented schema shared by every producer (docs/observability.md).

Left out: nothing.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

# Log-spaced defaults covering the ranges the serving stack observes.
SECONDS_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
BYTES_BUCKETS = tuple(float(10 ** e) for e in range(3, 13))     # 1KB..1TB
RATIO_BUCKETS = tuple(i / 10 for i in range(1, 11))             # 0.1..1.0


def flat_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """``name{k=v,...}`` with labels sorted; bare ``name`` when unlabeled."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotonic accumulator.  ``inc`` rejects negative deltas — counter
    monotonicity is an invariant the tests (and any rate computation
    downstream) rely on."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter decrement ({n}); use a Gauge")
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, free pages); ``set`` overwrites,
    ``max_seen`` / ``min_seen`` track the high/low-water marks for peak and
    headroom telemetry (``min_seen`` is None until the first ``set`` —
    unlike ``max_seen`` it cannot start at 0.0, or a pool that never drains
    would report zero headroom)."""
    __slots__ = ("value", "max_seen", "min_seen")

    def __init__(self):
        self.value = 0.0
        self.max_seen = 0.0
        self.min_seen: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)
        if v > self.max_seen:
            self.max_seen = float(v)
        if self.min_seen is None or v < self.min_seen:
            self.min_seen = float(v)


class Histogram:
    """Fixed-bucket histogram + exact percentiles from retained values.

    ``bounds`` are upper-inclusive bucket edges; values above the last edge
    land in the implicit overflow bucket (``counts`` has ``len(bounds)+1``
    entries).  Bucket counts serve the emitter (fixed-size, mergeable);
    the raw values (retained up to ``keep``, FIFO) serve ``percentile``,
    which matches ``numpy.percentile``'s default linear interpolation
    exactly — so trace-derived bench numbers cannot drift from the legacy
    computation they replaced.
    """
    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "_values", "_keep")

    def __init__(self, bounds: Sequence[float] = SECONDS_BUCKETS,
                 keep: int = 100_000):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"bucket bounds must be strictly increasing: "
                             f"{bounds}")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._values: List[float] = []
        self._keep = int(keep)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self._values) < self._keep:
            self._values.append(v)

    def observe_many(self, vs) -> None:
        """Bulk ``observe`` over a vector (numpy array OK) — state
        identical to looping ``observe``, but the bucketing is one
        ``searchsorted`` and a ``bincount`` instead of a Python
        bisect-append per element.  The numerics health plane folds
        per-dispatch vectors on the serving hot path (the int8 pool's
        grown scales: ~1,200 a tinyllama dispatch)."""
        import numpy as np
        vs = np.asarray(vs, dtype=np.float64).ravel()
        if vs.size == 0:
            return
        hits = np.bincount(np.searchsorted(self.bounds, vs, side="right"),
                           minlength=len(self.counts))
        self.counts = [c + int(n) for c, n in zip(self.counts, hits)]
        self.count += int(vs.size)
        self.sum += float(vs.sum())
        mn, mx = float(vs.min()), float(vs.max())
        if self.min is None or mn < self.min:
            self.min = mn
        if self.max is None or mx > self.max:
            self.max = mx
        room = self._keep - len(self._values)
        if room > 0:
            self._values.extend(vs[:room].tolist())

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile (0..100), ``numpy.percentile`` linear-interp
        semantics over the retained values; None when empty.  Falls back
        to bucket-edge interpolation if the retention window overflowed
        (counts beyond ``keep`` raw values)."""
        if not self.count:
            return None
        if self.count <= len(self._values):
            vals = sorted(self._values)
            rank = (q / 100.0) * (len(vals) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)
        # bucket interpolation: the edge below the target cumulative count
        target = (q / 100.0) * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.max)
        return self.max

    @staticmethod
    def of(values: Sequence[float],
           bounds: Sequence[float] = SECONDS_BUCKETS) -> "Histogram":
        """Histogram over a finished value list (the benches' one-shot
        percentile path: ``Histogram.of(lat).percentile(99)``)."""
        h = Histogram(bounds, keep=max(len(values), 1))
        for v in values:
            h.observe(v)
        return h

    def to_dict(self) -> Dict:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class Registry:
    """Flat namespace of metrics; get-or-create, so wiring is idempotent.

    The same (name, labels, kind) always returns the same object; asking
    for an existing name as a different kind raises (one schema, no
    shadowing).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, kind, name: str, labels: Dict[str, str], **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = kind(**kw)
            self._metrics[key] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {flat_name(*key)!r} already registered "
                            f"as {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Sequence[float] = SECONDS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    # -- views ------------------------------------------------------------
    def items(self):
        for (name, labels), m in sorted(self._metrics.items()):
            yield flat_name(name, labels), m

    def value(self, name: str, **labels) -> float:
        """Current scalar value of a counter/gauge (stats() convenience)."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        return self._metrics[key].value

    def snapshot(self) -> Dict:
        """JSON-able view: {"counters": {...}, "gauges": {...},
        "histograms": {name: Histogram.to_dict()},
        "gauge_marks": {name: {"max": ..., "min": ...}}} — the
        high/low-water marks ride along so peak/headroom telemetry
        (``pool.free_pages`` low-water) survives snapshot consumers like
        the Prometheus renderer."""
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "gauge_marks": {}}
        for fname, m in self.items():
            if isinstance(m, Counter):
                out["counters"][fname] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][fname] = m.value
                out["gauge_marks"][fname] = {"max": m.max_seen,
                                             "min": m.min_seen}
            else:
                out["histograms"][fname] = m.to_dict()
        return out

    @staticmethod
    def delta(new: Dict, old: Dict) -> Dict:
        """Counter deltas between two snapshots (rate windows)."""
        oc = old.get("counters", {})
        return {k: v - oc.get(k, 0.0)
                for k, v in new.get("counters", {}).items()}

    def to_prometheus(self) -> str:
        """This registry, right now, in Prometheus text exposition format
        (see ``prometheus_text``)."""
        return prometheus_text(self.snapshot())

    def scoped(self, **labels) -> "ScopedRegistry":
        """A label-scoped view over this registry: every counter/gauge/
        histogram created through the view carries ``labels`` merged into
        its identity.  This is the per-engine metrics-isolation seam — two
        ``ContinuousEngine``s sharing one registry get distinct
        ``tokens{replica=r0}`` / ``tokens{replica=r1}`` series instead of
        cross-contaminating one unlabeled counter (docs/observability.md)."""
        return ScopedRegistry(self, labels)


class ScopedRegistry:
    """Thin label-injecting facade over a base ``Registry``.

    Producers written against the Registry surface (``counter`` /
    ``gauge`` / ``histogram`` / ``value``) work unchanged; the fixed
    labels are merged under any call-site labels (call-site wins on key
    collision, so a scoped producer can still override deliberately).
    Views (``items`` / ``snapshot`` / ``delta`` / ``to_prometheus``)
    delegate to the base registry — the snapshot is the whole process,
    which is what the emitter wants.  Scopes nest: ``scoped()`` on a view
    merges further labels.
    """

    def __init__(self, base: "Registry", labels: Dict[str, object]):
        self.base = base
        self.labels: Dict[str, str] = {k: str(v) for k, v in labels.items()}

    def _merged(self, labels: Dict[str, object]) -> Dict[str, str]:
        merged = dict(self.labels)
        merged.update({k: str(v) for k, v in labels.items()})
        return merged

    def counter(self, name: str, **labels) -> Counter:
        return self.base.counter(name, **self._merged(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self.base.gauge(name, **self._merged(labels))

    def histogram(self, name: str, bounds: Sequence[float] = SECONDS_BUCKETS,
                  **labels) -> Histogram:
        return self.base.histogram(name, bounds=bounds,
                                   **self._merged(labels))

    def value(self, name: str, **labels) -> float:
        return self.base.value(name, **self._merged(labels))

    def scoped(self, **labels) -> "ScopedRegistry":
        return ScopedRegistry(self.base, self._merged(labels))

    # whole-process views (the emitter snapshots everything)
    def items(self):
        return self.base.items()

    def snapshot(self) -> Dict:
        return self.base.snapshot()

    @staticmethod
    def delta(new: Dict, old: Dict) -> Dict:
        return Registry.delta(new, old)

    def to_prometheus(self) -> str:
        return self.base.to_prometheus()


# ---------------------------------------------------------------------------
# Prometheus text exposition (no client library — the format is 14 lines)
# ---------------------------------------------------------------------------
def _prom_split(fname: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Flattened ``name{k=v,...}`` -> (prometheus_name, label pairs).
    Dots (our namespace separator) become underscores — Prometheus metric
    names admit ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    labels: List[Tuple[str, str]] = []
    if "{" in fname:
        fname, _, rest = fname.partition("{")
        for pair in rest.rstrip("}").split(","):
            k, _, v = pair.partition("=")
            labels.append((k, v))
    return fname.replace(".", "_").replace("-", "_"), labels


def _prom_labels(labels: List[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


def prometheus_text(snapshot: Dict) -> str:
    """Render a ``Registry.snapshot()`` dict in Prometheus text exposition
    format (version 0.0.4): counters as ``<name>_total``, gauges verbatim,
    histograms as cumulative ``_bucket{le=...}`` series (including the
    ``+Inf`` overflow) plus ``_sum`` and ``_count``.

    Operating on the *snapshot* (not the live registry) means the JSONL
    sidecar can feed a scrape pipeline after the fact:
    ``python -m repro_torch.obs --to-prom metrics.jsonl`` renders the last
    snapshot line of a serve run.  ``# TYPE`` headers are emitted once per
    metric family, series grouped under them, families sorted by name.
    """
    families: Dict[str, Dict] = {}

    def fam(pname: str, ptype: str) -> List[str]:
        f = families.setdefault(pname, {"type": ptype, "lines": []})
        if f["type"] != ptype:
            raise ValueError(f"metric family {pname!r} seen as both "
                             f"{f['type']} and {ptype}")
        return f["lines"]

    for fname, v in snapshot.get("counters", {}).items():
        pname, labels = _prom_split(fname)
        pname += "_total"
        fam(pname, "counter").append(f"{pname}{_prom_labels(labels)} {v!r}")
    for fname, v in snapshot.get("gauges", {}).items():
        pname, labels = _prom_split(fname)
        fam(pname, "gauge").append(f"{pname}{_prom_labels(labels)} {v!r}")
    # gauge high/low-water marks as companion series: max_seen/min_seen
    # would otherwise be dropped on the Prometheus path (a scrape only
    # sees point-in-time values — pool.free_pages low-water matters)
    for fname, marks in snapshot.get("gauge_marks", {}).items():
        pname, labels = _prom_split(fname)
        ls = _prom_labels(labels)
        fam(pname + "_max", "gauge").append(
            f"{pname}_max{ls} {float(marks['max'])!r}")
        if marks.get("min") is not None:
            fam(pname + "_min", "gauge").append(
                f"{pname}_min{ls} {float(marks['min'])!r}")
    for fname, h in snapshot.get("histograms", {}).items():
        pname, labels = _prom_split(fname)
        lines = fam(pname, "histogram")
        cum = 0
        for bound, c in zip(h["buckets"], h["counts"]):
            cum += c
            ls = _prom_labels(labels + [("le", repr(float(bound)))])
            lines.append(f"{pname}_bucket{ls} {cum}")
        ls = _prom_labels(labels + [("le", "+Inf")])
        lines.append(f"{pname}_bucket{ls} {h['count']}")
        lines.append(f"{pname}_sum{_prom_labels(labels)} {h['sum']!r}")
        lines.append(f"{pname}_count{_prom_labels(labels)} {h['count']}")

    out: List[str] = []
    for pname in sorted(families):
        f = families[pname]
        out.append(f"# TYPE {pname} {f['type']}")
        out.extend(f["lines"])
    return "\n".join(out) + ("\n" if out else "")
