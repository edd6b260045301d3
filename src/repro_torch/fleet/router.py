"""Fleet router: placement, retries, hedging, and crash failover over a
set of ``EngineReplica``s (port of ``repro/fleet/router.py``).

The router is the fleet's single intake.  Each ``step()`` runs one
control round::

    1. step every live replica (their engines run one scheduler round)
    2. collect terminal results from every live leg (first winner settles;
       a hedge loser is cancelled and its late result discarded)
    3. fail over replicas that went DOWN this round: salvage their
       in-flight requests and re-enqueue them for migration — resubmitted
       to a survivor with ``resume_tokens``, so recompute-prefill keeps
       greedy outputs token-identical to the B=1 oracle
    4. hedge requests whose primary leg has not produced a first token
       within the TTFT threshold (explicit ``hedge_after_s`` or
       ``hedge_p99_mult`` x the fleet's observed p99 TTFT)
    5. place pending requests (join-shortest-queue over HEALTHY replicas,
       DEGRADED as fallback), retrying refused placements with capped
       exponential backoff + seeded jitter, and shedding as REJECTED —
       deadline-doomed first, then lowest-priority-youngest — whenever the
       bounded pending buffer overflows (graceful degradation: the router
       never queues unboundedly)

Every submitted request settles in EXACTLY ONE terminal status at fleet
level, even when both legs of a hedged request or a crashed replica's
salvage race to deliver results — ``_settle`` is the single guarded entry
to the terminal map, and the fleet chaos suite (serve/faults.py
``run_fleet_chaos``) asserts the invariant under seeded kills.

Telemetry: ``fleet.*`` counters/gauges in the (unscoped) router registry;
per-replica series carry the ``replica=`` label via each engine's scoped
Obs view.  ``clock`` is injectable so the state-machine tests drive
backoff and hedge timers on a virtual clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import Obs
from ..serve.scheduler import FAILED, REJECTED, TERMINAL_STATUSES
from .replica import DOWN, HEALTHY

POLICIES = ("jsq", "round_robin")


@dataclasses.dataclass
class _FleetRequest:
    """Router-side state for one in-flight fleet request."""
    order: int
    request: object
    arrival_s: float
    deadline_s: Optional[float]               # absolute on the router clock
    resume_tokens: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    migrations: int = 0
    hedged: bool = False
    legs: List[Tuple[object, int]] = dataclasses.field(default_factory=list)
    first_placed_s: Optional[float] = None    # hedge timer origin
    retries: int = 0
    next_try_s: float = 0.0


class Router:
    """Health-aware load balancer + failover controller over replicas.

    ``replicas`` need only the ``EngineReplica`` interface (see
    fleet/replica.py) — the state-machine tests drive the router with
    host-only fakes.  ``max_pending`` bounds the router-side buffer of
    unplaced requests (default ``32 * len(replicas)``); overflow sheds.
    """

    def __init__(self, replicas: Sequence, *, policy: str = "jsq",
                 hedge_after_s: Optional[float] = None,
                 hedge_p99_mult: float = 4.0, hedge_min_s: float = 0.05,
                 hedge_min_samples: int = 8,
                 backoff_base_s: float = 0.002, backoff_cap_s: float = 0.1,
                 max_pending: Optional[int] = None, seed: int = 0,
                 obs: Optional[Obs] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r}: expected one of {POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        self.hedge_after_s = hedge_after_s
        self.hedge_p99_mult = float(hedge_p99_mult)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_min_samples = int(hedge_min_samples)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_pending = (32 * len(self.replicas) if max_pending is None
                            else int(max_pending))
        self.clock = clock
        self._t0: Optional[float] = None
        self._rng = np.random.RandomState(seed)
        self._rr = 0                           # round_robin cursor
        self.intake_closed = False
        self.obs = obs if obs is not None else Obs()
        self._order = 0
        self._states: Dict[int, _FleetRequest] = {}
        self._results: Dict[int, Dict] = {}
        self._pending: List[_FleetRequest] = []
        # (replica name, local order) -> fleet order, one entry per live leg
        self._leg_index: Dict[Tuple[str, int], int] = {}
        # legs of settled requests still owed a (discarded) result
        self._zombies: List[Tuple[object, int]] = []
        reg = self.obs.registry
        self._c_submitted = reg.counter("fleet.submitted")
        self._c_placed = reg.counter("fleet.placed")
        self._c_retries = reg.counter("fleet.place_retries")
        self._c_hedges = reg.counter("fleet.hedges")
        self._c_hedge_wins = {
            "primary": reg.counter("fleet.hedge_wins", leg="primary"),
            "hedge": reg.counter("fleet.hedge_wins", leg="hedge"),
        }
        self._c_failovers = reg.counter("fleet.failovers")
        self._c_migrated = reg.counter("fleet.migrated_requests")
        self._c_shed = {
            "deadline": reg.counter("fleet.shed", reason="deadline"),
            "overflow": reg.counter("fleet.shed", reason="overflow"),
            "no_live_replicas": reg.counter("fleet.shed",
                                            reason="no_live_replicas"),
        }
        self._c_term = {s: reg.counter("fleet.terminal", status=s)
                        for s in TERMINAL_STATUSES}
        self._h_ttft = reg.histogram("fleet.ttft_s")
        self._h_resume = reg.histogram(
            "fleet.migrated_resume_tokens",
            bounds=tuple(float(2 ** e) for e in range(11)))
        self._g_pending = reg.gauge("fleet.pending_depth")
        self._g_live = reg.gauge("fleet.replicas_live")
        self._g_live.set(len(self.replicas))

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        """Seconds on the router clock (0 at the first submit)."""
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    # -- intake ------------------------------------------------------------
    def submit(self, request, arrival_s: float = 0.0) -> int:
        """Queue one request with the fleet; returns its FLEET order (the
        key for ``result``).  Closed intake rejects immediately — like the
        engines, callers never lose a request."""
        for r in self.replicas:
            ms = r.max_seq
            if ms is not None and len(request.prompt) > ms:
                raise ValueError(f"prompt length {len(request.prompt)} "
                                 f"exceeds fleet max_seq {ms}")
        now = self.now()
        order = self._order
        self._order += 1
        self._c_submitted.inc()
        rel = getattr(request, "deadline_s", None)
        st = _FleetRequest(
            order=order, request=request, arrival_s=float(arrival_s),
            deadline_s=None if rel is None else float(arrival_s) + float(rel))
        if self.intake_closed:
            self._settle_unserved(st, REJECTED, shed_reason=None,
                                  register=False)
            return order
        self._states[order] = st
        self._pending.append(st)
        self._enforce_pending_bound(now)
        if order in self._states:       # may have been shed by the bound
            self._try_place_pending(now)
        return order

    def result(self, order: int, pop: bool = False) -> Optional[Dict]:
        """Fleet-level terminal result (None while in flight).  Results
        carry the engine schema plus ``replica`` (the winning replica, None
        for router-shed requests) and ``migrations``."""
        return (self._results.pop(order, None) if pop
                else self._results.get(order))

    def cancel(self, request_id) -> bool:
        """Cancel wherever the request lives: pending here, or on every
        replica currently holding a leg."""
        for st in list(self._states.values()):
            if st.request.id != request_id:
                continue
            if not st.legs:                     # pending at the router
                self._settle_unserved(st, "CANCELLED", shed_reason=None)
                return True
            return any(replica.cancel(request_id)
                       for replica, _ in st.legs)
        return False

    # -- control loop ------------------------------------------------------
    def step(self) -> bool:
        """One fleet control round; returns True if anything progressed."""
        now = self.now()
        progress = False
        for r in self.replicas:
            if r.state != DOWN:
                if r.step():
                    progress = True
        if self._collect(now):
            progress = True
        for r in self.replicas:
            if r.state == DOWN and not r.salvaged:
                self._failover(r, now)
                progress = True
        if self._maybe_hedge(now):
            progress = True
        self._try_place_pending(self.now())
        self._g_live.set(sum(1 for r in self.replicas if r.state != DOWN))
        self._g_pending.set(len(self._pending))
        return progress

    def generate(self, reqs: Sequence, arrival_times=None) -> List[Dict]:
        """Serve a workload to completion (the fleet mirror of
        ``ContinuousEngine.generate``); returns results in request order."""
        arr = ([0.0] * len(reqs) if arrival_times is None
               else [float(a) for a in arrival_times])
        orders = [self.submit(r, a) for r, a in zip(reqs, arr)]
        while any(o not in self._results for o in orders):
            if not self.step():
                time.sleep(5e-4)        # waiting on a simulated arrival
        return [self._results.pop(o) for o in orders]

    def drain(self) -> List[Dict]:
        """Close intake, run every in-flight request to a terminal status
        (placement and failover keep working during the drain), then drain
        the surviving replicas and close the shared obs.  Returns results
        that went terminal during the drain."""
        before = set(self._results)
        self.intake_closed = True
        idle_rounds = 0
        while self._states or self._pending:
            if self.step():
                idle_rounds = 0
            else:
                idle_rounds += 1
                if idle_rounds > 10_000:
                    raise RuntimeError(
                        f"fleet drain stall: {len(self._states)} requests "
                        f"cannot make progress")
                time.sleep(5e-4)
        for r in self.replicas:
            if r.state != DOWN:
                r.drain()
        self.obs.close()
        return [self._results[o] for o in sorted(set(self._results) - before)]

    @property
    def idle(self) -> bool:
        return not self._states and not self._pending

    # -- placement ---------------------------------------------------------
    def _candidates(self, exclude: Sequence = ()) -> List:
        """Live replicas eligible for a placement, best-first: HEALTHY
        before DEGRADED (DOWN never serves), ordered by the policy."""
        live = [r for r in self.replicas
                if r.state != DOWN and r not in exclude]
        healthy = [r for r in live if r.state == HEALTHY]
        pool = healthy if healthy else live
        if self.policy == "jsq":
            return sorted(pool, key=lambda r: (r.load, r.name))
        self._rr += 1
        n = len(pool)
        return [pool[(self._rr + i) % n] for i in range(n)] if n else []

    def _place(self, st: _FleetRequest, now: float,
               exclude: Sequence = ()) -> bool:
        """Try every eligible replica once, best-first.  A refusal
        (bounded engine queue, drain, replica died between the health check
        and the submit) moves on to the next candidate."""
        for replica in self._candidates(exclude=exclude):
            local, accepted = replica.submit(
                st.request, arrival_s=st.arrival_s,
                resume_tokens=st.resume_tokens or None,
                preemptions=st.preemptions)
            if accepted:
                st.legs.append((replica, local))
                self._leg_index[(replica.name, local)] = st.order
                if st.first_placed_s is None:
                    st.first_placed_s = now
                self._c_placed.inc()
                return True
        return False

    def _try_place_pending(self, now: float) -> None:
        if not self._pending:
            return
        if all(r.state == DOWN for r in self.replicas):
            # nothing can ever serve these — FAILED beats a silent hang
            for st in list(self._pending):
                self._settle_unserved(st, FAILED,
                                      shed_reason="no_live_replicas")
            self._pending = []
            return
        still: List[_FleetRequest] = []
        # iterate a snapshot: the deadline branch removes from _pending via
        # _settle_unserved, and mutating the live list mid-iteration would
        # skip (and thereby strand) the element after the shed one
        for st in list(self._pending):
            if st.order in self._results:
                continue                       # cancelled / shed meanwhile
            if st.deadline_s is not None and now > st.deadline_s:
                # deadline-doomed while unplaced: graceful degradation
                self._settle_unserved(st, REJECTED, shed_reason="deadline")
                continue
            if now < st.next_try_s:
                still.append(st)
                continue
            if self._place(st, now):
                continue
            st.retries += 1                    # every replica refused
            self._c_retries.inc()
            backoff = min(self.backoff_cap_s,
                          self.backoff_base_s * (2 ** min(st.retries, 10)))
            backoff *= 1.0 + self._rng.random_sample()   # jitter
            st.next_try_s = now + backoff
            still.append(st)
        self._pending = still
        self._g_pending.set(len(self._pending))

    def _enforce_pending_bound(self, now: float) -> None:
        """Shed until the pending buffer fits: deadline-doomed first, then
        fresh before migrated, lowest priority first, youngest first."""
        while len(self._pending) > self.max_pending:
            doomed = [st for st in self._pending
                      if st.deadline_s is not None and now > st.deadline_s]
            pool = doomed if doomed else self._pending
            victim = min(pool, key=lambda st: (
                bool(st.resume_tokens),
                getattr(st.request, "priority", 0),
                -st.order))
            self._pending.remove(victim)
            self._settle_unserved(victim, REJECTED, shed_reason="overflow")

    # -- completion --------------------------------------------------------
    def _collect(self, now: float) -> bool:
        progress = False
        for st in list(self._states.values()):
            for replica, local in list(st.legs):
                res = replica.result(local, pop=True)
                if res is not None:
                    self._settle(st, res, replica, now)
                    progress = True
                    break
        # hedge losers owe a (discarded) CANCELLED result; drop dead legs
        zombies: List[Tuple[object, int]] = []
        for replica, local in self._zombies:
            if replica.state == DOWN:
                continue
            if replica.result(local, pop=True) is None:
                zombies.append((replica, local))
        self._zombies = zombies
        return progress

    def _settle(self, st: _FleetRequest, res: Dict, replica, now: float
                ) -> None:
        """The single guarded entry to the fleet terminal map — exactly
        one result per fleet order, whoever delivers first."""
        if st.order in self._results:
            return
        out = dict(res)
        out["replica"] = replica.name
        out["migrations"] = st.migrations
        self._results[st.order] = out
        self._c_term[out["status"]].inc()
        if st.hedged:
            won = "primary" if (st.legs and st.legs[0][0] is replica) \
                else "hedge"
            self._c_hedge_wins[won].inc()
        q, p = out.get("queue_s"), out.get("prefill_s")
        if q is not None and p is not None:
            self._h_ttft.observe(q + p)
        self._states.pop(st.order, None)
        for other, local in st.legs:
            self._leg_index.pop((other.name, local), None)
            if other is replica:
                continue
            if other.state != DOWN:
                other.cancel(st.request.id)
                self._zombies.append((other, local))
        st.legs = []

    def _settle_unserved(self, st: _FleetRequest, status: str,
                         shed_reason: Optional[str] = "overflow",
                         register: bool = True) -> None:
        """Terminal result for a request the fleet never served (shed,
        rejected at intake, failed with no live replicas)."""
        if register and st.order in self._results:
            return
        res = {
            "id": st.request.id,
            "tokens": list(st.resume_tokens),
            "decode_len": len(st.resume_tokens),
            "status": status,
            "preemptions": st.preemptions,
            "tokens_per_s": 0.0,
            "prefill_s": None,
            "decode_s": 0.0,
            "queue_s": None,
            "latency_s": None,
            "replica": None,
            "migrations": st.migrations,
        }
        self._results[st.order] = res
        self._c_term[status].inc()
        if shed_reason is not None:
            self._c_shed[shed_reason].inc()
        self._states.pop(st.order, None)
        if st in self._pending:
            self._pending.remove(st)

    # -- hedging -----------------------------------------------------------
    def _hedge_threshold(self) -> Optional[float]:
        if self.hedge_after_s is not None:
            return self.hedge_after_s
        if self._h_ttft.count >= self.hedge_min_samples:
            p99 = self._h_ttft.percentile(99)
            if p99 is not None:
                return max(self.hedge_min_s, self.hedge_p99_mult * p99)
        return None

    def _maybe_hedge(self, now: float) -> bool:
        thr = self._hedge_threshold()
        if thr is None:
            return False
        live = sum(1 for r in self.replicas if r.state != DOWN)
        if live < 2:
            return False
        hedged_any = False
        for st in list(self._states.values()):
            if st.hedged or not st.legs or st.first_placed_s is None:
                continue
            if now - st.first_placed_s <= thr:
                continue
            replica, local = st.legs[0]
            if replica.state != DOWN and replica.first_token_seen(local):
                continue
            if self._place(st, now, exclude=[r for r, _ in st.legs]):
                st.hedged = True
                self._c_hedges.inc()
                hedged_any = True
        return hedged_any

    # -- failover ----------------------------------------------------------
    def _failover(self, replica, now: float) -> None:
        """Salvage a DOWN replica: surface its unconsumed terminal results,
        then migrate every lost in-flight request to a survivor via
        resume-token resubmission (recompute-prefill keeps greedy outputs
        token-identical)."""
        salvage = replica.salvage()
        self._c_failovers.inc()
        for local, res in sorted(salvage.results.items()):
            order = self._leg_index.get((replica.name, local))
            st = self._states.get(order) if order is not None else None
            if st is not None:
                self._settle(st, res, replica, now)
        for lost in salvage.lost:
            order = self._leg_index.pop((replica.name, lost.local_order),
                                        None)
            st = self._states.get(order) if order is not None else None
            if st is None:
                continue                # settled by another leg already
            st.legs = [(r, l) for r, l in st.legs if r is not replica]
            if st.legs:
                continue                # a live hedge leg carries on
            if len(lost.resume_tokens) > len(st.resume_tokens):
                st.resume_tokens = list(lost.resume_tokens)
                st.preemptions = lost.preemptions
            st.migrations += 1
            self._c_migrated.inc()
            self._h_resume.observe(len(st.resume_tokens))
            st.hedged = False
            st.first_placed_s = None    # hedge timer restarts on the move
            st.next_try_s = 0.0
            if st not in self._pending:
                self._pending.append(st)
        stale = [k for k in self._leg_index if k[0] == replica.name]
        for k in stale:
            del self._leg_index[k]
        self._enforce_pending_bound(now)

    # -- telemetry ---------------------------------------------------------
    def terminal_counts(self) -> Dict[str, int]:
        return {s: int(c.value) for s, c in self._c_term.items()}

    def stats(self) -> Dict:
        v = self.obs.registry.value
        return {
            "policy": self.policy,
            "replicas": [r.stats() for r in self.replicas],
            "live_replicas": sum(1 for r in self.replicas
                                 if r.state != DOWN),
            "submitted": int(v("fleet.submitted")),
            "placed": int(v("fleet.placed")),
            "place_retries": int(v("fleet.place_retries")),
            "hedges": int(v("fleet.hedges")),
            "hedge_wins": {leg: int(c.value)
                           for leg, c in self._c_hedge_wins.items()},
            "failovers": int(v("fleet.failovers")),
            "migrated_requests": int(v("fleet.migrated_requests")),
            "shed": {reason: int(c.value)
                     for reason, c in self._c_shed.items()},
            "pending_depth": len(self._pending),
            "statuses": self.terminal_counts(),
        }
