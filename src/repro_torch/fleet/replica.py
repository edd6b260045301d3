"""EngineReplica: an RPC-shaped wrapper around one ``ContinuousEngine``
with a health state machine (port of ``repro/fleet/replica.py``).

The router talks to replicas through this narrow interface only —
``submit`` / ``step`` / ``cancel`` / ``result`` / ``first_token_seen`` /
``salvage`` / ``drain`` / ``stats`` plus the ``state`` / ``load`` /
``max_seq`` properties — so a host-side fake (tests) or a remote stub
drops in without router changes.

Health state machine::

    HEALTHY ──anomaly / step timeout──▶ DEGRADED
    DEGRADED ──recover_after clean steps──▶ HEALTHY
    DEGRADED/HEALTHY ──down_after consecutive timeouts──▶ DOWN   (hung)
    any ──exception in step / injected crash──▶ DOWN             (crashed)

Signals: dispatch heartbeats (wall time of each ``step`` call — a hang
fault or a wedged device program shows up as a step timeout),
``engine.anomalies`` (NaN/Inf-guard trips), SLO watchdog alerts (the
``slo.alerts`` counter an ``obs.slo.SloWatchdog`` bound to this
replica's registry bumps — sustained quality burn degrades the replica
the same way an anomaly does), and a consecutive-timeout counter.  DOWN
is terminal: the replica refuses further work and the router calls
``salvage()`` exactly once to recover its in-flight state.

``salvage`` reads the engine's host-side scheduler state (queue entries,
running slots' generated tokens, unconsumed terminal results).  In this
in-process reproduction that read is direct; over a real RPC boundary the
same information is the recovery log a control plane replays.  The dead
replica's device pool is abandoned — pool-restoration invariants apply to
SURVIVORS (the fleet chaos suite asserts exactly that).  On the card its
pool and captured decode step stay allocated while the replica object
lives.

The step timeout measures the wall time of ``engine.step()``: a kernel
library built inside a step (a first launch on a machine where nothing
was built yet) reads as a timeout.  The fleet entry points
(``launch/serve.py --replicas``, ``serve/faults.py:run_fleet_chaos``)
build every library before the first replica on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..serve.scheduler import REJECTED

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
DOWN = "DOWN"

# numeric encoding for the replica.health gauge (telemetry only)
_HEALTH_LEVEL = {HEALTHY: 0.0, DEGRADED: 1.0, DOWN: 2.0}


@dataclasses.dataclass
class LostRequest:
    """One in-flight request recovered from a dead replica.

    ``resume_tokens`` is everything the replica had generated (queue
    resume state or a running slot's token list) — the router migrates the
    request to a survivor by resubmitting with these tokens, which
    recompute-prefill teacher-forces so greedy decode continues
    token-identically."""
    request: object
    resume_tokens: List[int]
    preemptions: int
    local_order: int


@dataclasses.dataclass
class Salvage:
    """Everything ``salvage()`` recovers: unconsumed terminal results
    (keyed by the replica-local order) and the lost in-flight requests."""
    results: Dict[int, Dict]
    lost: List[LostRequest]


class EngineReplica:
    """One engine behind the fleet interface, with health tracking.

    ``step_timeout_s`` is the dispatch-heartbeat bound: a ``step`` call
    exceeding it counts as a timeout (DEGRADED), and ``down_after``
    consecutive timeouts mark the replica DOWN (hung).  Any exception out
    of the engine — or an injected ``crash_p`` fault — is an immediate
    crash (DOWN).  ``recover_after`` consecutive clean steps return a
    DEGRADED replica to HEALTHY.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, name: str, engine, *, faults=None,
                 step_timeout_s: float = 5.0, down_after: int = 3,
                 recover_after: int = 5,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = str(name)
        self.engine = engine
        self.faults = faults
        self.step_timeout_s = float(step_timeout_s)
        self.down_after = int(down_after)
        self.recover_after = int(recover_after)
        self.clock = clock
        self.state = HEALTHY
        self.down_reason: Optional[str] = None
        self.salvaged = False
        self.last_heartbeat_s: Optional[float] = None
        self.consecutive_timeouts = 0
        self._clean_steps = 0
        self._last_anomalies = 0
        # arrival/deadline stamps arrive router-relative; a warmed engine's
        # serve clock would read them as seconds in the past
        reset = getattr(engine, "reset_serve_clock", None)
        if reset is not None:
            reset()
        # health telemetry rides the engine's (replica-scoped) registry
        reg = engine.obs.registry
        self._g_health = reg.gauge("replica.health")
        self._g_health.set(_HEALTH_LEVEL[HEALTHY])
        self._c_timeouts = reg.counter("replica.step_timeouts")
        self._c_crashes = reg.counter("replica.crashes")
        # SLO consumption: any watchdog bound to this registry bumps
        # labelled slo.alerts counters; the replica folds their SUM so a
        # sustained quality burn (drift, agreement, clip rate) degrades it
        # exactly like a NaN-guard anomaly would
        self._reg = reg
        self._last_slo_alerts = self._slo_alerts()

    # -- properties the router keys on ------------------------------------
    @property
    def live(self) -> bool:
        return self.state != DOWN

    @property
    def load(self) -> int:
        """Join-shortest-queue key: queued + running requests."""
        sched = self.engine.scheduler
        return sched.queue_depth + len(sched.running)

    @property
    def max_seq(self) -> Optional[int]:
        return getattr(self.engine, "max_seq", None)

    # -- request lifecycle -------------------------------------------------
    def submit(self, request, arrival_s: float = 0.0,
               resume_tokens: Optional[Sequence[int]] = None,
               preemptions: int = 0) -> Tuple[int, bool]:
        """Place one request; returns ``(local_order, accepted)``.

        A locally-REJECTED submission (bounded queue / draining) is a
        TRANSIENT placement failure at fleet level — the immediate
        REJECTED result the engine materialized is consumed here so the
        router can retry on another replica without leaking a terminal."""
        if not self.live:
            return -1, False
        order = self.engine.submit(request, arrival_s,
                                   resume_tokens=resume_tokens,
                                   preemptions=preemptions)
        res = self.engine.result(order)
        if res is not None and res["status"] == REJECTED:
            self.engine.result(order, pop=True)
            return order, False
        return order, True

    def step(self) -> bool:
        """One engine scheduler round, fenced by the health machine.
        Returns True if the engine made progress; a DOWN replica is inert."""
        if not self.live:
            return False
        if self.faults is not None and self.faults.maybe_crash():
            self._crash("injected crash")
            return False
        t0 = self.clock()
        hang = (self.faults.hang_delay() if self.faults is not None else 0.0)
        if hang > 0.0:
            time.sleep(hang)               # injected wedge: heartbeat stalls
        try:
            progress = bool(self.engine.step())
        except Exception as e:             # a real fault, not an injected one
            self._crash(f"engine.step raised: {e!r}")
            return False
        t1 = self.clock()
        self.last_heartbeat_s = t1
        anomalies = self.engine.anomalies
        anomaly_delta = anomalies - self._last_anomalies
        self._last_anomalies = anomalies
        slo_alerts = self._slo_alerts()
        slo_delta = slo_alerts - self._last_slo_alerts
        self._last_slo_alerts = slo_alerts
        timed_out = (t1 - t0) > self.step_timeout_s
        if timed_out:
            self._c_timeouts.inc()
            self.consecutive_timeouts += 1
            if self.consecutive_timeouts >= self.down_after:
                self._mark_down(f"hung: {self.consecutive_timeouts} "
                                f"consecutive step timeouts "
                                f"(> {self.step_timeout_s}s)")
                return progress
            self._degrade()
        elif anomaly_delta > 0 or slo_delta > 0:
            self.consecutive_timeouts = 0
            self._degrade()
        else:
            self.consecutive_timeouts = 0
            if self.state == DEGRADED:
                self._clean_steps += 1
                if self._clean_steps >= self.recover_after:
                    self.state = HEALTHY
                    self._g_health.set(_HEALTH_LEVEL[HEALTHY])
        return progress

    def _slo_alerts(self) -> float:
        """Sum of every ``slo.alerts*`` counter in the replica registry
        (the watchdog labels per rule/severity; health folds the total)."""
        total = 0.0
        for fname, m in self._reg.items():
            if fname.startswith("slo.alerts"):
                total += m.value
        return total

    def cancel(self, request_id) -> bool:
        if not self.live:
            return False
        return self.engine.cancel(request_id)

    def result(self, local_order: int, pop: bool = False) -> Optional[Dict]:
        return self.engine.result(local_order, pop=pop)

    def first_token_seen(self, local_order: int) -> bool:
        """Has this request streamed its first token here?  The hedging
        trigger.  Reads the engine's live trace when obs is enabled; with
        obs disabled hedging falls back to terminal-result absence."""
        tr = self.engine._traces.get(local_order)
        if tr is not None:
            return tr.first_token_s is not None
        return self.engine.result(local_order) is not None

    def drain(self) -> List[Dict]:
        if not self.live:
            return []
        return self.engine.drain()

    # -- failure + recovery ------------------------------------------------
    def force_crash(self, reason: str = "forced crash") -> None:
        """Deterministic kill switch (the fleet chaos suite's mid-serving
        replica kill)."""
        self._crash(reason)

    def _crash(self, reason: str) -> None:
        self._c_crashes.inc()
        self._mark_down(reason)

    def _mark_down(self, reason: str) -> None:
        if self.state == DOWN:
            return
        self.state = DOWN
        self.down_reason = reason
        self._g_health.set(_HEALTH_LEVEL[DOWN])

    def _degrade(self) -> None:
        self._clean_steps = 0
        if self.state == HEALTHY:
            self.state = DEGRADED
            self._g_health.set(_HEALTH_LEVEL[DEGRADED])

    def salvage(self) -> Salvage:
        """Recover a DOWN replica's in-flight state, exactly once.

        Returns unconsumed terminal results plus a ``LostRequest`` per
        queued entry (fresh or resume), doomed entry, and running slot —
        running slots contribute their generated tokens as resume state.
        The engine is left inert; its device pool is abandoned."""
        if self.state != DOWN:
            raise RuntimeError(f"salvage on {self.state} replica "
                               f"{self.name!r}: only DOWN replicas salvage")
        if self.salvaged:
            return Salvage({}, [])
        self.salvaged = True
        eng = self.engine
        results = dict(eng._results)
        eng._results.clear()
        lost: List[LostRequest] = []
        sched = eng.scheduler
        for entry in list(sched.queue):
            lost.append(LostRequest(entry.request,
                                    list(entry.resume_tokens),
                                    entry.preemptions, entry.order))
        sched.queue.clear()
        for entry in sched.drain_doomed():
            lost.append(LostRequest(entry.request,
                                    list(entry.resume_tokens),
                                    entry.preemptions, entry.order))
        for slot in sched.running:
            lost.append(LostRequest(slot.request, list(slot.tokens),
                                    slot.preemptions, slot.order))
        sched.close_intake()
        lost.sort(key=lambda l: l.local_order)
        return Salvage(results, lost)

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> Dict:
        st = {
            "name": self.name,
            "state": self.state,
            "down_reason": self.down_reason,
            "load": self.load,
            "consecutive_timeouts": self.consecutive_timeouts,
            "step_timeouts": int(self._c_timeouts.value),
            "crashes": int(self._c_crashes.value),
            "slo_alerts": int(self._slo_alerts()),
            "last_heartbeat_s": self.last_heartbeat_s,
        }
        st["engine"] = self.engine.stats()
        return st
