"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The subset of ``repro/obs/metrics.py`` that the scheduler, the page
allocator and the engine's ``stats()`` read: ``Counter``, ``Gauge``,
``Histogram`` (bucket counts and sum) and ``Registry``
(get-or-create by dotted name plus optional labels).  Exporters, scoped
views and emitters are not ported yet.

``Counter.inc`` / ``Gauge.set`` are one float add / store on an object the
caller holds; registry lookups happen once, at wiring time.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Optional, Sequence, Tuple

SECONDS_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def flat_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """``name{k=v,...}`` with labels sorted; bare ``name`` when unlabeled."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotonic accumulator; ``inc`` rejects negative deltas."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter decrement ({n}); use a Gauge")
        self.value += n


class Gauge:
    """Point-in-time value with high/low-water marks (``min_seen`` is None
    until the first ``set``)."""
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
    """Fixed upper-inclusive buckets plus an overflow bucket, count and sum."""
    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = SECONDS_BUCKETS):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"bucket bounds must be strictly increasing: "
                             f"{bounds}")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v


class Registry:
    """Flat namespace of metrics; get-or-create, so wiring is idempotent.
    Asking for an existing name as a different kind raises."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, kind, name: str, labels: Dict[str, object], **kw):
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

    def value(self, name: str, **labels) -> float:
        """Current scalar value of a counter or gauge."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        return self._metrics[key].value

