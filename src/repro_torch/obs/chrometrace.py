"""Chrome-trace (Perfetto) export of a serve run's timeline (port of
``repro/obs/chrometrace.py``).

One JSON file in the Chrome Trace Event Format — open it at
https://ui.perfetto.dev (or chrome://tracing) to *look at* what the
registry and TraceStore only aggregate:

* **engine dispatch lanes** (process "engine"): one lane per dispatch
  kind (``prefill_4p``, ``decode_chunk``, ...), slices from the
  profiler's bounded dispatch log, each carrying its roofline fraction
  as args — a slow bucket is visually wider AND redder-on-sort than
  its neighbours.
* **one lane per request** (process "requests"): queue → prefill →
  decode slices derived from the ``RequestTrace`` marks, preemptions as
  thread-scoped instants, terminal status + token counts as args on
  every slice.  Fleet runs label traces with their serving replica;
  each replica's requests group under their own process
  (``requests@r0``, ``requests@r1``, ...) so a failover migration reads
  as the lane jumping processes.
* **counter tracks**: free pages, queue depth, tokens in flight —
  whatever gauges the profiler was asked to ``watch()`` — sampled at
  each dispatch end.

All timestamps are the obs clock (seconds, rebased to engine creation)
scaled to microseconds, so every lane shares one timeline.  The export
is a pure read of state obs already holds — building it after a serve
run costs the run nothing.

Wired behind ``python -m repro_torch.launch.serve ... --trace-out trace.json``.

Left out: nothing.  The dispatch lanes come from the port's profiler
(``obs/prof.py``), whose spans end at the host read each dispatch already
makes.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .trace import RequestTrace

# Process ids are arbitrary but fixed: lanes group under them in the UI.
PID_ENGINE = 1
PID_REQUESTS = 2

_US = 1e6     # obs clock seconds -> trace microseconds


def _meta(pid: int, name: str, tid: Optional[int] = None,
          sort: Optional[int] = None) -> List[Dict]:
    """process_name / thread_name / sort-index metadata records."""
    out = []
    if tid is None:
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": name}})
        if sort is not None:
            out.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                        "args": {"sort_index": sort}})
    else:
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": name}})
        if sort is not None:
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": sort}})
    return out


def dispatch_events(profiler) -> List[Dict]:
    """Engine dispatch lanes: one thread per dispatch kind, "X" complete
    slices from the profiler's event log (kind, t0, t1, roofline_frac)."""
    events: List[Dict] = []
    tids: Dict[str, int] = {}
    for kind, t0, t1, frac in profiler.events:
        tid = tids.get(kind)
        if tid is None:
            tid = tids[kind] = len(tids)
        args: Dict = {"dispatch": kind}
        if frac is not None:
            args["roofline_frac"] = round(frac, 6)
            cost = profiler.costs.get(kind)
            if cost is not None:
                args["flops"] = cost.flops
                args["bytes_accessed"] = cost.bytes_accessed
                args["bound"] = cost.bound
        events.append({"ph": "X", "pid": PID_ENGINE, "tid": tid,
                       "name": kind, "cat": "dispatch",
                       "ts": max(t0, 0.0) * _US,
                       "dur": max(t1 - t0, 0.0) * _US,
                       "args": args})
    meta: List[Dict] = []
    for kind, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.extend(_meta(PID_ENGINE, kind, tid=tid, sort=tid))
    return meta + events


def counter_events(profiler) -> List[Dict]:
    """Counter tracks from the profiler's watched-gauge samples.  Chrome
    counters are per-(pid, name); consecutive duplicate samples are
    dropped (the track is a step function anyway)."""
    events: List[Dict] = []
    for name, series in sorted(profiler.samples.items()):
        last = None
        for t, v in series:
            if v == last:
                continue
            last = v
            events.append({"ph": "C", "pid": PID_ENGINE, "name": name,
                           "ts": max(t, 0.0) * _US, "args": {"value": v}})
    return events


def request_events(trace: RequestTrace, tid: Optional[int] = None,
                   pid: int = PID_REQUESTS) -> List[Dict]:
    """One request's lane: a slice between each adjacent pair of present
    lifecycle marks, preemptions as thread-scoped instants.

    Served requests carry all four marks → exactly queue/prefill/decode.
    Unserved terminals span whatever marks exist — a request cancelled in
    queue renders one long "queue" slice ending at its retire — so the
    lane always covers enqueue → retire and the phase names stay honest
    about where the request died.  Every slice carries the terminal
    status and token counts as args.
    """
    tid = trace.order if tid is None else tid
    args = {"order": trace.order, "id": trace.id,
            "status": trace.status or "FINISHED",
            "prompt_len": trace.prompt_len, "decode_len": trace.decode_len}
    if trace.replica is not None:
        args["replica"] = trace.replica
    # adjacent present marks; the slice is named for the phase it opens
    marks = [("queue", trace.enqueue_s), ("prefill", trace.admit_s),
             ("decode", trace.first_token_s), (None, trace.retire_s)]
    present = [(n, t) for n, t in marks if t is not None]
    events: List[Dict] = []
    for (name, t0), (_, t1) in zip(present, present[1:]):
        events.append({"ph": "X", "pid": pid, "tid": tid,
                       "name": name, "cat": "request",
                       "ts": max(t0, 0.0) * _US,
                       "dur": max(t1 - t0, 0.0) * _US,
                       "args": dict(args)})
    for t, recompute in trace.preemptions:
        events.append({"ph": "i", "pid": pid, "tid": tid,
                       "name": "preempt", "cat": "request", "s": "t",
                       "ts": max(t, 0.0) * _US,
                       "args": {"recompute_tokens": recompute}})
    return events


def build_trace(obs, extra_meta: Optional[Dict] = None) -> Dict:
    """Assemble the full trace dict from an ``Obs`` bundle: dispatch lanes
    + counter tracks (profiler) and one lane per completed request
    (TraceStore).  Events are sorted by timestamp (metadata first) so the
    file is monotone — some trace viewers stream it.
    """
    meta = _meta(PID_ENGINE, "engine", sort=0) + \
        _meta(PID_REQUESTS, "requests", sort=1)
    events: List[Dict] = []
    prof = getattr(obs, "profiler", None)
    if prof is not None:
        for ev in dispatch_events(prof):
            (meta if ev["ph"] == "M" else events).append(ev)
        events.extend(counter_events(prof))
    # replica-labelled traces get their own process per replica
    # (requests@r0 = PID_REQUESTS+1, ...); unlabelled stay on "requests"
    replica_pids: Dict[str, int] = {}
    for trace in obs.traces.completed:
        if trace.replica is None:
            pid = PID_REQUESTS
        else:
            pid = replica_pids.get(trace.replica)
            if pid is None:
                pid = PID_REQUESTS + 1 + len(replica_pids)
                replica_pids[trace.replica] = pid
                meta.extend(_meta(pid, f"requests@{trace.replica}",
                                  sort=pid - 1))
        meta.extend(_meta(pid, f"req {trace.order}",
                          tid=trace.order, sort=trace.order))
        events.extend(request_events(trace, pid=pid))
    events.sort(key=lambda e: e["ts"])
    out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if prof is not None:
        out["otherData"] = {"hardware": prof.spec.name}
    if extra_meta:
        out.setdefault("otherData", {}).update(extra_meta)
    return out


def write_trace(obs, path: str, extra_meta: Optional[Dict] = None) -> Dict:
    """Build and write the trace JSON; returns the dict (tests assert on
    it without re-reading the file)."""
    trace = build_trace(obs, extra_meta=extra_meta)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_trace(trace: Dict) -> None:
    """Schema check for CI smoke: raises ValueError on a malformed trace.

    Asserts the envelope, per-event required keys, non-negative
    monotonically non-decreasing ``ts`` over timed events, and
    non-negative durations.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace: missing traceEvents envelope")
    last_ts = None
    for i, ev in enumerate(trace["traceEvents"]):
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "i"):
            raise ValueError(f"trace event {i}: unknown ph {ph!r}")
        if "pid" not in ev or "name" not in ev:
            raise ValueError(f"trace event {i}: missing pid/name")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"trace event {i}: bad ts {ts!r}")
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"trace event {i}: ts {ts} < previous "
                             f"{last_ts} (events must be sorted)")
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"trace event {i}: bad dur {dur!r}")


def main(argv=None) -> int:
    """``python -m repro_torch.obs.chrometrace --validate trace.json`` — CI's
    schema smoke for ``--trace-out`` artifacts."""
    import argparse
    p = argparse.ArgumentParser(prog="repro_torch.obs.chrometrace",
                                description=__doc__.splitlines()[0])
    p.add_argument("--validate", metavar="FILE", required=True,
                   help="chrome-trace JSON file to schema-check")
    p.add_argument("--min-requests", type=int, default=0,
                   help="require at least N request lanes")
    args = p.parse_args(argv)
    with open(args.validate) as f:
        trace = json.load(f)
    validate_trace(trace)
    lanes = {(ev.get("pid"), ev.get("tid")) for ev in trace["traceEvents"]
             if ev.get("cat") == "request" and ev.get("ph") == "X"}
    if len(lanes) < args.min_requests:
        raise SystemExit(f"{args.validate}: {len(lanes)} request lanes "
                         f"< required {args.min_requests}")
    n = len(trace["traceEvents"])
    print(f"{args.validate}: OK ({n} events, {len(lanes)} request lanes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
