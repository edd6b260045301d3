"""Periodic JSON-lines emitter (port of ``repro/obs/emit.py``; the line
schema is ``repro``'s, so each package validates the other's files): registry snapshots + completed traces.

STEP-DRIVEN, not threaded: the engines call ``tick()`` between device
dispatches (the same boundary the scheduler runs on), and every
``every``-th tick flushes one ``snapshot`` line plus one ``trace`` line per
request completed since the last flush.  No background thread means no
locks on the metric hot path and no emitter work racing a dispatch — the
paper's hierarchical-control idiom: telemetry rides the control-plane
cadence the engine already has.

Line schema (every line is one JSON object; docs/observability.md):

  {"type": "snapshot", "seq": n, "t_s": <obs-clock seconds>,
   "counters": {name: float}, "gauges": {name: float},
   "histograms": {name: {buckets, counts, count, sum, min, max, p50, p99}}}

  {"type": "trace", "t_s": ..., **RequestTrace.to_dict()}

  {"type": "alert", "t_s": ..., "rule": ..., "severity": "warn"|"page",
   "series": ..., "value": ..., "threshold": ..., "op": ...}

Snapshots additionally carry an optional ``gauge_marks`` section
(high/low-water marks per gauge); alert lines come from the SLO
watchdog (``obs/slo.py``) when one is attached.

``validate_line`` / ``validate_jsonl`` check the schema (required keys,
numeric types, histogram bucket conservation, trace span ordering) — the
CI emitter smoke runs ``python -m repro_torch.obs.emit --validate metrics.jsonl``
against a real serve run.

The sink is a file path (append, line-buffered flush per batch) or a
callback receiving each line dict (in-process consumers: tests, benches).

Left out: nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

from .metrics import Registry
from .trace import TraceStore

SNAPSHOT_KEYS = ("type", "seq", "t_s", "counters", "gauges", "histograms")
# SLO watchdog alert lines (obs/slo.py): one record per rule excursion
ALERT_KEYS = ("type", "t_s", "rule", "severity", "series", "value",
              "threshold", "op")
ALERT_SEVERITIES = ("warn", "page")
ALERT_OPS = (">", ">=", "<", "<=")
TRACE_KEYS = ("type", "t_s", "id", "order", "prompt_len", "decode_len",
              "status", "enqueue_s", "admit_s", "first_token_s", "retire_s",
              "queue_s", "ttft_s", "prefill_s", "decode_s", "tpot_s",
              "latency_s", "chunks", "preemptions", "replica")

# Terminal statuses a trace line may carry (serve/scheduler.py defines the
# canonical constants; the emitter validates against the same literals —
# duplicated here so the SCHEMA has no import edge into the serve stack).
# None = legacy served trace (batch-engine lines predating statuses).
TRACE_STATUSES = (None, "FINISHED_EOS", "FINISHED_BUDGET", "TIMEOUT",
                  "CANCELLED", "REJECTED", "FAILED")
# statuses whose timeline must carry all four marks + >=1 decoded token
_SERVED = (None, "FINISHED_EOS", "FINISHED_BUDGET")


class Emitter:
    def __init__(self, registry: Registry, traces: TraceStore, *,
                 path: Optional[str] = None,
                 callback: Optional[Callable[[Dict], None]] = None,
                 every: int = 1, clock: Callable[[], float] = None,
                 watchdog=None):
        if path is None and callback is None:
            raise ValueError("Emitter needs a path or a callback sink")
        self.registry = registry
        self.traces = traces
        self.path = path
        self.callback = callback
        # optional obs.slo.SloWatchdog: evaluated on every snapshot this
        # emitter writes; fired alerts become JSONL lines right behind it
        self.watchdog = watchdog
        self.every = max(1, int(every))
        self.clock = clock or (lambda: 0.0)
        self.ticks = 0
        self.seq = 0
        self.lines_written = 0
        self._file = None
        self._closed = False

    # -- sink -------------------------------------------------------------
    def _write(self, obj: Dict) -> None:
        if self.callback is not None:
            self.callback(obj)
        if self.path is not None:
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write(json.dumps(obj) + "\n")
        self.lines_written += 1

    # -- cadence ----------------------------------------------------------
    def tick(self) -> None:
        """Engine heartbeat: flush every ``every``-th call."""
        if self._closed:
            return
        self.ticks += 1
        if self.ticks % self.every == 0:
            self.flush()

    def flush(self) -> None:
        """One snapshot line + all traces completed since the last flush."""
        if self._closed:
            return
        t = self.clock()
        snap = {"type": "snapshot", "seq": self.seq, "t_s": t}
        snap.update(self.registry.snapshot())
        self._write(snap)
        self.seq += 1
        if self.watchdog is not None:
            for alert in self.watchdog.observe(snap):
                self._write(alert)
        for tr in self.traces.drain_pending():
            self._write({"type": "trace", "t_s": t, **tr.to_dict()})
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        """Final flush, then stop.  Idempotent: a second close (or a tick/
        flush after close — e.g. ``drain()`` called twice) is a no-op
        instead of reopening the file for a duplicate trailing snapshot."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._file is not None:
            self._file.close()
            self._file = None


# ---------------------------------------------------------------------------
# Schema validation (tests + CI emitter smoke)
# ---------------------------------------------------------------------------
def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_line(obj: Dict) -> None:
    """Raise ValueError unless ``obj`` is a schema-valid emitter line."""
    if not isinstance(obj, dict):
        raise ValueError(f"line is not an object: {obj!r}")
    kind = obj.get("type")
    if kind == "snapshot":
        missing = [k for k in SNAPSHOT_KEYS if k not in obj]
        if missing:
            raise ValueError(f"snapshot missing keys {missing}")
        for section in ("counters", "gauges"):
            for k, v in obj[section].items():
                if not _num(v):
                    raise ValueError(f"{section}[{k}] not numeric: {v!r}")
        for name, h in obj["histograms"].items():
            if len(h["counts"]) != len(h["buckets"]) + 1:
                raise ValueError(f"histogram {name}: {len(h['counts'])} "
                                 f"counts for {len(h['buckets'])} bounds")
            if sum(h["counts"]) != h["count"]:
                raise ValueError(f"histogram {name}: bucket counts "
                                 f"{sum(h['counts'])} != count {h['count']}")
        # optional section (newer emitters): gauge high/low-water marks
        for name, marks in obj.get("gauge_marks", {}).items():
            if not _num(marks.get("max")):
                raise ValueError(f"gauge_marks[{name}]: non-numeric max "
                                 f"{marks!r}")
            mn = marks.get("min")
            if mn is not None and (not _num(mn) or mn > marks["max"]):
                raise ValueError(f"gauge_marks[{name}]: bad min {marks!r}")
    elif kind == "alert":
        missing = [k for k in ALERT_KEYS if k not in obj]
        if missing:
            raise ValueError(f"alert missing keys {missing}")
        if obj["severity"] not in ALERT_SEVERITIES:
            raise ValueError(f"alert {obj['rule']!r}: unknown severity "
                             f"{obj['severity']!r}")
        if obj["op"] not in ALERT_OPS:
            raise ValueError(f"alert {obj['rule']!r}: unknown op "
                             f"{obj['op']!r}")
        for k in ("t_s", "value", "threshold"):
            if not _num(obj[k]):
                raise ValueError(f"alert {obj['rule']!r}: non-numeric "
                                 f"{k} {obj[k]!r}")
        for k in ("rule", "series"):
            if not isinstance(obj[k], str) or not obj[k]:
                raise ValueError(f"alert: bad {k} {obj.get(k)!r}")
    elif kind == "trace":
        missing = [k for k in TRACE_KEYS if k not in obj]
        if missing:
            raise ValueError(f"trace missing keys {missing}")
        status = obj["status"]
        if status not in TRACE_STATUSES:
            raise ValueError(f"trace {obj['order']}: unknown status "
                             f"{status!r}")
        marks = [obj["enqueue_s"], obj["admit_s"], obj["first_token_s"],
                 obj["retire_s"]]
        served = status in _SERVED
        required = marks if served else [marks[0], marks[3]]
        if any(not _num(t) for t in required):
            raise ValueError(f"trace {obj['order']}: non-numeric marks "
                             f"{marks}")
        present = [t for t in marks if t is not None]
        if any(not _num(t) for t in present):
            raise ValueError(f"trace {obj['order']}: non-numeric marks "
                             f"{marks}")
        if any(b < a for a, b in zip(present, present[1:])):
            raise ValueError(f"trace {obj['order']}: span marks out of "
                             f"order: {marks}")
        if served and obj["decode_len"] < 1:
            raise ValueError(f"trace {obj['order']}: retired with "
                             f"decode_len {obj['decode_len']}")
    else:
        raise ValueError(f"unknown line type {kind!r}")


def validate_jsonl(path: str) -> Dict[str, int]:
    """Validate every line of an emitter file; returns line-type counts."""
    counts = {"snapshot": 0, "trace": 0, "alert": 0}
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            try:
                validate_line(obj)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from e
            counts[obj["type"]] += 1
    if not counts["snapshot"]:
        raise ValueError(f"{path}: no snapshot lines")
    return counts


def last_snapshot(path: str) -> Dict:
    """The final (cumulative) snapshot line of an emitter file."""
    snap = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            if obj.get("type") == "snapshot":
                snap = obj
    if snap is None:
        raise ValueError(f"{path}: no snapshot lines")
    return snap


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate an obs emitter JSONL file (CI smoke) or "
                    "render its last snapshot for a Prometheus scrape.")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--validate", metavar="FILE",
                      help="schema-check every line of FILE")
    mode.add_argument("--to-prom", metavar="FILE",
                      help="print FILE's last snapshot in Prometheus text "
                           "exposition format (docs/observability.md)")
    ap.add_argument("--min-traces", type=int, default=0,
                    help="with --validate: require at least N trace lines")
    args = ap.parse_args(argv)
    if args.to_prom is not None:
        from .metrics import prometheus_text
        sys.stdout.write(prometheus_text(last_snapshot(args.to_prom)))
        return 0
    counts = validate_jsonl(args.validate)
    if counts["trace"] < args.min_traces:
        print(f"[obs.emit] {args.validate}: {counts['trace']} trace lines "
              f"< required {args.min_traces}", file=sys.stderr)
        return 1
    print(f"[obs.emit] {args.validate}: OK "
          f"({counts['snapshot']} snapshots, {counts['trace']} traces, "
          f"{counts['alert']} alerts)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
