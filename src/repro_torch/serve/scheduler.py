"""Continuous-batching request scheduler: admission, preemption, and the
request lifecycle over decode slots, between device dispatches.

A port of ``repro/serve/scheduler.py``, which is pure host code: the logic
is unchanged.  The ContinuousEngine consults it between
dispatches of the decode loop.  The hierarchy mirrors the paper's
hardware control stack — a tiny control plane (queue + slot states + block
tables) steering a large data plane (the paged pool + the device loop):

* requests queue FIFO; admission happens only between device dispatches,
  into slots whose previous request retired (no batch-drain barrier),
* under the default OPTIMISTIC admission policy only the prefill's page
  footprint is reserved at admit; decode-time page growth can fail, and on
  exhaustion the scheduler PREEMPTS the youngest running slot — its pages
  go back to the pool and the request re-queues at the head for
  recompute-prefill (prompt + generated-so-far), bounded per request by
  ``max_preemptions``.  ``admission="reserve"`` keeps the legacy
  worst-case up-front reservation (a running request then never stalls),
* every request ends in EXACTLY ONE terminal status (the ``FINISHED_EOS``
  … ``FAILED`` constants below); deadlines are enforced both in-queue
  (``expire_queue``) and in-flight (the engine retires expired slots),
  ``cancel`` removes a request wherever it lives, and a bounded submit
  queue rejects with backpressure instead of growing unboundedly.

Admission is strictly FIFO (no head-of-line skipping): a large request at
the head blocks later small ones, trading a little throughput for no
starvation.  Preempted requests re-queue AT THE HEAD (oldest first), so
FIFO order is preserved across preemption — the queue is always sorted by
submission order.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..obs.metrics import Registry
from .kvcache import BlockTable, pages_for

# Terminal request statuses — every submitted request reaches exactly one
# (the chaos suite in serve/faults.py asserts this).  The strings are the
# trace/emitter schema (obs/emit.py validates against the same literals).
FINISHED_EOS = "FINISHED_EOS"          # emitted eos_id within budget
FINISHED_BUDGET = "FINISHED_BUDGET"    # decode budget exhausted
TIMEOUT = "TIMEOUT"                    # deadline expired (queued or running)
CANCELLED = "CANCELLED"                # cancel(request_id)
REJECTED = "REJECTED"                  # bounded-queue backpressure / drain
FAILED = "FAILED"                      # anomaly (NaN/Inf) or page starvation

TERMINAL_STATUSES = (FINISHED_EOS, FINISHED_BUDGET, TIMEOUT, CANCELLED,
                     REJECTED, FAILED)
FINISHED_STATUSES = (FINISHED_EOS, FINISHED_BUDGET)


@dataclasses.dataclass
class QueueEntry:
    """One queued request.  ``resume_tokens`` is non-empty iff the entry is
    a preempted request waiting for recompute-prefill (the generated tokens
    are appended to the prompt and teacher-forced through prefill)."""
    order: int                         # submission index (result ordering)
    request: object                    # engine-level Request
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None  # ABSOLUTE (arrival + request budget)
    resume_tokens: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0


@dataclasses.dataclass
class SlotState:
    """One decode slot's in-flight request (None = free)."""
    index: int
    request: object = None            # engine-level Request
    order: int = -1                   # submission index (result ordering)
    pos: int = 0                      # next cache position (= tokens seen)
    budget: int = 0                   # decode steps allowed THIS life
    tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_s: float = 0.0
    admit_s: float = 0.0
    deadline_s: Optional[float] = None
    preemptions: int = 0              # times this request was preempted
    resume_len: int = 0               # tokens recomputed via prefill
    total_budget: int = 0             # resume_len + budget (whole request)
    tif: int = 0                      # tokens charged to the in-flight budget

    @property
    def free(self) -> bool:
        return self.request is None


@dataclasses.dataclass
class PrepareDecode:
    """Outcome of pre-dispatch page growth (``Scheduler.prepare_decode``)."""
    runnable: List[SlotState]                 # pages cover the next chunk
    stalled: List[SlotState]                  # no pages, no victim: skip
    preempted: List[Tuple[int, QueueEntry]]   # (slot index, re-queued entry)


class Scheduler:
    """FIFO admission + slot lifecycle over a BlockTable.

    Lifecycle counters live in a ``repro.obs`` Registry (one is created
    internally when none is passed): ``sched.submitted`` / ``.admitted`` /
    ``.retired`` / ``.preempted`` / ``.stalled`` counters,
    ``sched.deferred{reason=...}`` for admission attempts that parked,
    ``sched.terminal{status=...}`` counting every terminal transition,
    the ``sched.recompute_tokens`` histogram (tokens re-prefilled per
    preemption), and ``sched.queue_depth`` / ``sched.tokens_in_flight``
    gauges (peaks via the gauge high-water marks).  ``stats()`` is a view
    over that registry plus the allocator's page accounting.
    """

    def __init__(self, table: BlockTable, *, max_seq: int,
                 max_tokens_in_flight: int,
                 registry: Optional[Registry] = None,
                 admission: str = "optimistic",
                 max_queue: Optional[int] = None,
                 max_preemptions: int = 4):
        if admission not in ("optimistic", "reserve"):
            raise ValueError(f"admission {admission!r}: expected "
                             f"'optimistic' or 'reserve'")
        self.table = table
        self.max_seq = int(max_seq)
        self.max_tokens_in_flight = int(max_tokens_in_flight)
        self.admission = admission
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_preemptions = int(max_preemptions)
        self.slots = [SlotState(i) for i in range(table.table.shape[0])]
        self.queue: Deque[QueueEntry] = deque()
        self._doomed: List[QueueEntry] = []
        self.tokens_in_flight = 0
        self.intake_closed = False
        self.registry = registry if registry is not None else Registry()
        reg = self.registry
        self._c_submitted = reg.counter("sched.submitted")
        self._c_admitted = reg.counter("sched.admitted")
        self._c_retired = reg.counter("sched.retired")
        self._c_preempted = reg.counter("sched.preempted")
        self._c_stalled = reg.counter("sched.stalled")
        self._c_defer_budget = reg.counter("sched.deferred",
                                           reason="token_budget")
        self._c_defer_pages = reg.counter("sched.deferred", reason="pages")
        self._c_term = {s: reg.counter("sched.terminal", status=s)
                        for s in TERMINAL_STATUSES}
        self._h_recompute = reg.histogram(
            "sched.recompute_tokens",
            bounds=tuple(float(2 ** e) for e in range(11)))
        self._g_queue = reg.gauge("sched.queue_depth")
        self._g_inflight = reg.gauge("sched.tokens_in_flight")
        self._g_pages = reg.gauge("sched.pages_in_use")

    # registry-backed lifecycle counts (legacy attribute names preserved)
    @property
    def submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value)

    @property
    def retired(self) -> int:
        return int(self._c_retired.value)

    @property
    def preempted(self) -> int:
        return int(self._c_preempted.value)

    @property
    def peak_tokens_in_flight(self) -> int:
        return int(self._g_inflight.max_seen)

    @property
    def peak_pages_in_use(self) -> int:
        return int(self._g_pages.max_seen)

    def terminal_counts(self) -> Dict[str, int]:
        """Terminal transitions per status (exactly one per request)."""
        return {s: int(c.value) for s, c in self._c_term.items()}

    # -- queue ------------------------------------------------------------
    def submit(self, request, arrival_s: float = 0.0,
               resume_tokens: Optional[List[int]] = None,
               preemptions: int = 0) -> Tuple[int, bool]:
        """Queue a request; returns ``(order, accepted)``.

        ``accepted`` is False when intake is closed (drain) or the bounded
        queue is full — the caller owns surfacing the REJECTED terminal
        (the counter is bumped here; orders stay unique either way).
        Deadlines are absolute: ``arrival_s + request.deadline_s``.

        ``resume_tokens`` submits the request as a RESUME entry — tokens it
        already generated elsewhere are teacher-forced through prefill
        exactly like a local preemption's recompute, so greedy decode
        continues token-identically.  This is the cross-replica failover
        migration seam (repro.fleet): a request salvaged from a crashed
        replica re-enters a survivor mid-stream.  Resume entries survive
        ``flush_queue`` (they are in-flight work, not fresh queue).
        """
        order = self.submitted
        self._c_submitted.inc()
        if self.intake_closed or (self.max_queue is not None
                                  and len(self.queue) >= self.max_queue):
            self._c_term[REJECTED].inc()
            return order, False
        rel = getattr(request, "deadline_s", None)
        self.queue.append(QueueEntry(
            order=order, request=request, arrival_s=arrival_s,
            deadline_s=None if rel is None else arrival_s + float(rel),
            resume_tokens=list(resume_tokens) if resume_tokens else [],
            preemptions=int(preemptions)))
        self._g_queue.set(len(self.queue))
        return order, True

    def close_intake(self) -> None:
        """Stop accepting new submissions (drain step 1)."""
        self.intake_closed = True

    def expire_queue(self, now_s: float) -> List[QueueEntry]:
        """Remove queued entries whose deadline has passed; returns them.
        The caller owns surfacing the TIMEOUT results/traces."""
        expired = [e for e in self.queue
                   if e.deadline_s is not None and now_s > e.deadline_s]
        if expired:
            gone = {e.order for e in expired}
            self.queue = deque(e for e in self.queue if e.order not in gone)
            for _ in expired:
                self._c_term[TIMEOUT].inc()
            self._g_queue.set(len(self.queue))
        return expired

    def cancel(self, request_id) -> Optional[Tuple[str, object]]:
        """Find ``request_id`` wherever it lives.  Returns
        ``("queued", QueueEntry)`` (already removed; CANCELLED counted) or
        ``("running", SlotState)`` (the caller retires the slot at the next
        step boundary) or None when unknown / already terminal."""
        for entry in self.queue:
            if entry.request.id == request_id:
                self.queue.remove(entry)
                self._c_term[CANCELLED].inc()
                self._g_queue.set(len(self.queue))
                return ("queued", entry)
        for slot in self.running:
            if slot.request.id == request_id:
                return ("running", slot)
        return None

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def running(self) -> List[SlotState]:
        return [s for s in self.slots if not s.free]

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.free for s in self.slots)

    # -- admission --------------------------------------------------------
    def _plan(self, entry: QueueEntry) -> Tuple[int, int, int, int]:
        """(effective prompt len, clamped decode steps, prefill positions,
        worst-case positions) for an entry.  A resumed entry's effective
        prompt is prompt + generated-so-far; its remaining budget shrinks
        by what it already produced, so the worst-case footprint is
        identical to the fresh request's — recompute never inflates it."""
        req = entry.request
        s = len(req.prompt) + len(entry.resume_tokens)
        rem_new = req.max_new_tokens - len(entry.resume_tokens)
        steps = max(1, min(rem_new, self.max_seq - s + 1))
        page = self.table.page_size
        spad = pages_for(s, page) * page          # right-pad prefill bucket
        return s, steps, spad, max(spad, s + steps - 1)

    def try_admit(self, now_s: float = 0.0,
                  arrived_before: Optional[float] = None):
        """Admit queued requests FIFO into free slots; yields filled slots.

        Stops at the first request that does not fit (budget or pages) —
        order is preserved, nothing is skipped.  ``arrived_before`` gates
        admission on simulated arrival times (benchmarks).

        The token budget always charges the worst case (prompt + clamped
        budget).  Pages: ``admission="reserve"`` reserves the worst-case
        position footprint up front; ``"optimistic"`` reserves only the
        prefill bucket — decode growth happens in ``prepare_decode`` and
        can preempt.
        """
        out: List[SlotState] = []
        free = deque(s for s in self.slots if s.free)
        while self.queue and free:
            entry = self.queue[0]
            if (arrived_before is not None
                    and entry.arrival_s > arrived_before):
                break
            s, steps, spad, worst = self._plan(entry)
            if len(entry.request.prompt) > self.max_seq:
                raise ValueError(
                    f"prompt length {len(entry.request.prompt)} exceeds "
                    f"max_seq {self.max_seq}")
            tokens = s + steps
            # liveness: an entry whose worst case exceeds the WHOLE pool
            # (possible after preemption grows a resume prompt, or with an
            # undersized pool) would defer forever — fail it instead.
            cap = min(self.table.allocator.num_pages - 1,
                      self.table.max_pages_per_slot)
            if (pages_for(worst, self.table.page_size) > cap
                    or tokens > self.max_tokens_in_flight):
                self.queue.popleft()
                self._c_term[FAILED].inc()
                self._doomed.append(entry)
                self._g_queue.set(len(self.queue))
                continue
            if self.tokens_in_flight + tokens > self.max_tokens_in_flight:
                self._c_defer_budget.inc()
                break
            slot = free[0]
            positions = spad if self.admission == "optimistic" else worst
            if not self.table.reserve(slot.index, positions):
                self._c_defer_pages.inc()
                break                              # pool exhausted: wait
            free.popleft()
            self.queue.popleft()
            slot.request = entry.request
            slot.order = entry.order
            slot.pos = s
            slot.budget = steps
            slot.tokens = list(entry.resume_tokens)
            slot.arrival_s = entry.arrival_s
            slot.admit_s = now_s
            slot.deadline_s = entry.deadline_s
            slot.preemptions = entry.preemptions
            slot.resume_len = len(entry.resume_tokens)
            slot.total_budget = slot.resume_len + steps
            slot.tif = tokens
            self.tokens_in_flight += tokens
            self._c_admitted.inc()
            out.append(slot)
        self._g_queue.set(len(self.queue))
        self._g_inflight.set(self.tokens_in_flight)
        self._g_pages.set(self.table.allocator.in_use)
        return out

    def drain_doomed(self) -> List[QueueEntry]:
        """Entries ``try_admit`` failed as unadmittable (already counted
        FAILED); the caller surfaces their results/traces."""
        out, self._doomed = self._doomed, []
        return out

    # -- preemption -------------------------------------------------------
    def _victim(self) -> Optional[SlotState]:
        """Youngest running slot still under its preemption bound."""
        cands = [s for s in self.running
                 if s.preemptions < self.max_preemptions]
        return max(cands, key=lambda s: s.order) if cands else None

    def preempt(self, slot: SlotState) -> QueueEntry:
        """Evict a running slot: free its pages, re-queue it AT THE HEAD
        for recompute-prefill with its generated tokens as resume state.
        The engine owns clearing its device-side mirrors for the slot."""
        assert not slot.free, f"preempting free slot {slot.index}"
        self.tokens_in_flight -= slot.tif
        self.table.release(slot.index)
        entry = QueueEntry(
            order=slot.order, request=slot.request,
            arrival_s=slot.arrival_s, deadline_s=slot.deadline_s,
            resume_tokens=list(slot.tokens),
            preemptions=slot.preemptions + 1)
        self.queue.appendleft(entry)
        self._clear(slot)
        self._c_preempted.inc()
        self._h_recompute.observe(len(entry.resume_tokens))
        self._g_queue.set(len(self.queue))
        self._g_inflight.set(self.tokens_in_flight)
        self._g_pages.set(self.table.allocator.in_use)
        return entry

    def prepare_decode(self, chunk: int) -> PrepareDecode:
        """Grow every running slot's pages to cover the next ``chunk``
        decode steps (oldest slot first).  On allocation failure the
        YOUNGEST preemptible running slot is evicted and the reserve is
        retried; a slot with no victim available stalls for this dispatch
        (the engine masks it out).  Under ``admission="reserve"`` the
        worst case is already reserved, so this never allocates.
        """
        runnable: List[SlotState] = []
        stalled: List[SlotState] = []
        preempted: List[Tuple[int, QueueEntry]] = []
        for slot in sorted(self.running, key=lambda s: s.order):
            if slot.free:
                continue                  # preempted as a victim this round
            steps = min(chunk, slot.total_budget - len(slot.tokens))
            if steps <= 0:
                continue                  # nothing left; engine retires it
            need = slot.pos + steps       # positions written so far + next
            ok = self.table.reserve(slot.index, need)
            while not ok and not slot.free:
                victim = self._victim()
                if victim is None:
                    stalled.append(slot)
                    self._c_stalled.inc()
                    break
                preempted.append((victim.index, self.preempt(victim)))
                if victim is slot:
                    break                 # evicted itself: re-queued
                ok = self.table.reserve(slot.index, need)
            if ok and not slot.free:
                runnable.append(slot)
        self._g_pages.set(self.table.allocator.in_use)
        return PrepareDecode(runnable, stalled, preempted)

    # -- retirement -------------------------------------------------------
    def retire(self, slot: SlotState, status: str = FINISHED_BUDGET) -> Dict:
        """Free the slot + its pages; returns the per-request result core.
        ``status`` is the request's terminal state (counted here — the one
        place a slot-resident request goes terminal)."""
        assert not slot.free, f"retiring free slot {slot.index}"
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"unknown terminal status {status!r}")
        self.tokens_in_flight -= slot.tif
        self.table.release(slot.index)
        result = {
            "id": slot.request.id,
            "order": slot.order,
            "tokens": list(slot.tokens),
            "decode_len": len(slot.tokens),
            "status": status,
            "preemptions": slot.preemptions,
        }
        self._clear(slot)
        self._c_retired.inc()
        self._c_term[status].inc()
        self._g_inflight.set(self.tokens_in_flight)
        self._g_pages.set(self.table.allocator.in_use)
        return result

    def _clear(self, slot: SlotState) -> None:
        slot.request = None
        slot.order = -1
        slot.tokens = []
        slot.pos = 0
        slot.budget = 0
        slot.deadline_s = None
        slot.preemptions = 0
        slot.resume_len = 0
        slot.total_budget = 0
        slot.tif = 0

    # -- drain ------------------------------------------------------------
    def flush_queue(self) -> List[QueueEntry]:
        """Drop FRESH queued entries (drain: admitted work finishes, queued
        work is shed as REJECTED).  Preempted entries — in-flight work that
        happens to be queued for recompute — survive and run to completion.
        Returns the dropped entries; the caller surfaces their results."""
        keep: Deque[QueueEntry] = deque()
        dropped: List[QueueEntry] = []
        for entry in self.queue:
            if entry.resume_tokens:
                keep.append(entry)
            else:
                dropped.append(entry)
        self.queue = keep
        for _ in dropped:
            self._c_term[REJECTED].inc()
        self._g_queue.set(len(self.queue))
        return dropped

    # -- telemetry --------------------------------------------------------
    def stats(self) -> Dict:
        return {
            "queue_depth": self.queue_depth,
            "running": len(self.running),
            "tokens_in_flight": self.tokens_in_flight,
            "peak_tokens_in_flight": self.peak_tokens_in_flight,
            "pages_in_use": self.table.allocator.in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "page_utilization": self.table.utilization(),
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "preempted": self.preempted,
            "stalled": int(self._c_stalled.value),
            "recompute_tokens": self._h_recompute.sum,
            "admission": self.admission,
            "max_queue": self.max_queue,
            "max_preemptions": self.max_preemptions,
            "statuses": self.terminal_counts(),
            "deferred_token_budget": int(self._c_defer_budget.value),
            "deferred_pages": int(self._c_defer_pages.value),
        }
