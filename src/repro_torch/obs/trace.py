"""Request lifecycle tracing (port of ``repro/obs/trace.py``, unchanged but
for this docstring): enqueue → admit → prefill → first-token →
per-chunk-decode → retire, one timeline per request in both engines.

Every timestamp is seconds on ONE monotonic clock (``time.perf_counter``;
the owning ``Obs`` rebases it to its creation).  Span boundaries are taken
only after the engine has synchronised with the device (a host read of
the dispatch outputs), so spans measure device work,
not dispatch latency — the engines enforce this, the trace just records.

Derived latencies (the serving headline numbers, computed HERE so the
benchmarks and production telemetry share one definition and can never
drift):

* ``queue_s``   = admit − enqueue          (admission wait)
* ``ttft_s``    = first_token − enqueue    (time to first token)
* ``prefill_s`` = first_token − admit      (engine-side prefill span)
* ``decode_s``  = retire − first_token     (decode span)
* ``tpot_s``    = decode_s / (decode_len − 1)   (per-token decode latency;
  None for single-token requests)
* ``latency_s`` = retire − enqueue         (end-to-end)

Ordering is an invariant, not a convention: ``finish`` raises if the
timeline is not ``enqueue ≤ admit ≤ first_token ≤ retire`` (hypothesis-
swept in tests/test_obs.py).

Lifecycle hardening (see docs/serving.md) adds a terminal ``status`` and
``preemptions`` spans.  A request can now go terminal WITHOUT ever being
served — rejected at submit, cancelled or expired in queue, failed at
prefill — so validation is status-aware: the full four-mark timeline is
required only for the served outcomes (``status`` None — the legacy
engines — or ``FINISHED_*``); other terminals require just
``enqueue ≤ retire`` plus ordering over whichever marks exist, and the
derived spans return None when their marks are missing.

Left out: nothing; ``replica`` stays ``None`` until the fleet (``repro``'s
``fleet/``) is ported.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class RequestTrace:
    id: int                       # engine Request.id
    order: int                    # submission order (unique per engine)
    prompt_len: int
    enqueue_s: float
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    retire_s: Optional[float] = None
    decode_len: int = 0
    # (t_end_s, new_tokens) per decode dispatch that advanced this request
    chunks: List = dataclasses.field(default_factory=list)
    # terminal status (serve/scheduler.py constants); None = legacy served
    status: Optional[str] = None
    # (t_s, recompute_tokens) per preemption: the request was evicted and
    # re-queued with recompute_tokens to teacher-force through prefill
    preemptions: List = dataclasses.field(default_factory=list)
    # owning replica name (repro.fleet); None = single-engine serve.  Orders
    # are unique per ENGINE, so (replica, order) is the fleet-wide trace key
    # and the Chrome-trace exporter groups request lanes per replica pid.
    replica: Optional[str] = None

    # -- lifecycle marks --------------------------------------------------
    def mark_admit(self, t: float) -> None:
        self.admit_s = float(t)

    def mark_first_token(self, t: float) -> None:
        self.first_token_s = float(t)
        self.decode_len = 1

    def mark_chunk(self, t: float, new_tokens: int) -> None:
        self.chunks.append((float(t), int(new_tokens)))
        self.decode_len += int(new_tokens)

    def mark_preempt(self, t: float, recompute_tokens: int) -> None:
        self.preemptions.append((float(t), int(recompute_tokens)))

    def mark_retire(self, t: float) -> None:
        self.retire_s = float(t)

    @property
    def served(self) -> bool:
        """Did this request run to a normal finish?  Only then is the full
        four-mark timeline guaranteed (status None = legacy engines)."""
        return self.status is None or self.status.startswith("FINISHED")

    # -- derived spans (None when a required mark is missing) -------------
    @property
    def queue_s(self) -> Optional[float]:
        if self.admit_s is None:
            return None
        return self.admit_s - self.enqueue_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.enqueue_s

    @property
    def prefill_s(self) -> Optional[float]:
        if self.first_token_s is None or self.admit_s is None:
            return None
        return self.first_token_s - self.admit_s

    @property
    def decode_s(self) -> Optional[float]:
        if self.retire_s is None or self.first_token_s is None:
            return None
        return self.retire_s - self.first_token_s

    @property
    def tpot_s(self) -> Optional[float]:
        if self.decode_len <= 1 or self.decode_s is None:
            return None
        return self.decode_s / (self.decode_len - 1)

    @property
    def latency_s(self) -> Optional[float]:
        if self.retire_s is None:
            return None
        return self.retire_s - self.enqueue_s

    def validate(self) -> None:
        """Span-ordering invariant; raises ValueError on a broken timeline.

        Served traces (status None / FINISHED_*) must carry all four marks.
        Unserved terminals (TIMEOUT / CANCELLED / REJECTED / FAILED) may
        lack admit/first-token — they still need enqueue + retire and
        ordering over the marks they do have."""
        marks = [("enqueue", self.enqueue_s), ("admit", self.admit_s),
                 ("first_token", self.first_token_s),
                 ("retire", self.retire_s)]
        required = (marks if self.served
                    else [marks[0], marks[3]])
        missing = [n for n, t in required if t is None]
        if missing:
            raise ValueError(f"trace {self.order}: missing marks {missing}")
        present = [(n, t) for n, t in marks if t is not None]
        for (an, at), (bn, bt) in zip(present, present[1:]):
            if bt < at:
                raise ValueError(f"trace {self.order}: {bn} ({bt}) before "
                                 f"{an} ({at})")

    def to_dict(self) -> Dict:
        """The emitter's JSONL trace payload (docs/observability.md)."""
        return {
            "id": self.id,
            "order": self.order,
            "prompt_len": self.prompt_len,
            "decode_len": self.decode_len,
            "status": self.status,
            "enqueue_s": self.enqueue_s,
            "admit_s": self.admit_s,
            "first_token_s": self.first_token_s,
            "retire_s": self.retire_s,
            "queue_s": self.queue_s,
            "ttft_s": self.ttft_s,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "tpot_s": self.tpot_s,
            "latency_s": self.latency_s,
            "chunks": [list(c) for c in self.chunks],
            "preemptions": [list(p) for p in self.preemptions],
            "replica": self.replica,
        }


class TraceStore:
    """Active traces by submission order + a bounded completed buffer.

    ``finish`` validates the timeline and moves the trace to ``completed``
    (a deque capped at ``max_completed`` so an emitterless engine cannot
    grow without bound); the emitter drains ``pending`` — traces completed
    since the last flush — without disturbing ``completed`` readers
    (benches iterate ``completed`` post-hoc).
    """

    def __init__(self, max_completed: int = 100_000):
        # keyed (replica, order): a fleet shares one store and every
        # replica's engine numbers its own submissions from zero
        self.active: Dict[tuple, RequestTrace] = {}
        self.completed: Deque[RequestTrace] = deque(maxlen=max_completed)
        self._pending: Deque[RequestTrace] = deque(maxlen=max_completed)

    def start(self, id: int, order: int, prompt_len: int,
              enqueue_s: float, replica: Optional[str] = None
              ) -> RequestTrace:
        tr = RequestTrace(id=id, order=order, prompt_len=prompt_len,
                          enqueue_s=float(enqueue_s), replica=replica)
        self.active[(replica, order)] = tr
        return tr

    def get(self, order: int,
            replica: Optional[str] = None) -> Optional[RequestTrace]:
        return self.active.get((replica, order))

    def finish(self, trace: RequestTrace) -> RequestTrace:
        trace.validate()
        self.active.pop((trace.replica, trace.order), None)
        self.completed.append(trace)
        self._pending.append(trace)
        return trace

    def drain_pending(self) -> List[RequestTrace]:
        out = list(self._pending)
        self._pending.clear()
        return out

    def clear(self) -> None:
        """Drop completed traces (benches call between warm/timed passes)."""
        self.completed.clear()
        self._pending.clear()
