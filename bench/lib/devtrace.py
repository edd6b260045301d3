"""The device trace of a traced run's slice: ``torch.profiler`` over a
fixed stretch of the window, reduced to aggregates as it stops (no
Chrome trace is written).

The benchmark marks its own host spans with ``record_function``
(``bench.slice`` around the whole slice; ``bench.submit``,
``bench.step`` and ``bench.observe`` inside it), so the device's
activities and the host's spans share the profiler's clock.  From the
trace come:

* ``kernels``: device seconds by kernel name (the function's name, without
  its ``void``, template arguments, parameters or namespace);
* ``busy_s``: the union of every device activity (kernels, copies,
  sets) inside the slice; ``slice_s``: the slice's length;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by the benchmark's innermost span open at its middle
  (``bench.between`` where none is).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SPANS = ("bench.submit", "bench.step", "bench.observe")
SLICE = "bench.slice"


def base_name(name: str) -> str:
    """``void (anonymous namespace)::bc_fused_kernel<0>(Args)`` ->
    ``bc_fused_kernel``: no return type, namespace, template arguments or
    parameters."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    for i, ch in enumerate(s):
        if ch in "<(":
            s = s[:i]
            break
    return s.split("::")[-1].strip() or name


def _is_device(e) -> bool:
    """A device activity (kernel, copy, set), not the device-side shadow
    of a host annotation."""
    return (str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation()
            and not e.name().startswith("bench."))


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def reduce(events) -> Optional[Dict]:
    """The aggregates of one slice's kineto events (module docstring), or
    None where the slice span is missing."""
    spans: Dict[str, List[Tuple[int, int]]] = {s: [] for s in SPANS}
    window = None
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if _is_device(e):
            dev.append((s, end, name))
        elif str(e.device_type()).endswith("CUDA"):
            continue                # a host span's shadow on the device
        elif name == SLICE:
            window = (s, end)
        elif name in spans:
            spans[name].append((s, end))
    if window is None:
        return None
    w0, w1 = window
    kernels: Dict[str, float] = {}
    intervals = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        intervals.append((s, e))
        key = base_name(name)
        kernels[key] = kernels.get(key, 0.0) + (e - s) / 1e9
    busy = union_s(intervals)
    # the idle stretches between device activities inside the window
    gaps = []
    cursor = w0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        label = "bench.between"
        for span, ivs in spans.items():
            if any(a <= mid <= b for a, b in ivs):
                label = span
        labelled.append([label, (g1 - g0) / 1e9])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "busy_s": busy, "slice_s": (w1 - w0) / 1e9,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": labelled}


class Profiler:
    """Starts ``torch.profiler`` (host and device activities) and, on
    ``stop``, returns ``reduce`` of what it recorded."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> Optional[Dict]:
        self._prof.__exit__(None, None, None)
        return reduce(self._prof.profiler.kineto_results.events())



def warm(device_type: str) -> None:
    """Start and stop the profiler once (its start-up, CUPTI's on the card,
    takes seconds): set-up, so that the slice's start stalls nothing."""
    import torch
    p = Profiler(device_type)
    torch.zeros(1, device="cuda" if device_type == "cuda" else "cpu").add_(1)
    p.stop()
