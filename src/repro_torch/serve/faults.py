"""Deterministic seeded fault injection and the chaos invariant suite
(port of ``repro/serve/faults.py``).

The serving stack has to survive contention by design, so this module
makes failure a first-class, reproducible input.  ``FaultInjector`` hooks
three seams of the continuous engine:

* **allocator failure** (``alloc_fail_p``): ``PageAllocator.alloc``
  consults the injector and fails as if the pool were empty, driving the
  optimistic-admission preemption and stall paths far harder than organic
  page pressure would;
* **dispatch delay** (``dispatch_delay_p`` / ``dispatch_delay_s``): a
  host-side sleep before a decode dispatch, widening the windows in which
  deadlines expire and cancels land mid-flight;
* **slot corruption** (``corrupt_p``): NaN-poisons the first owned page
  of a running slot before a dispatch; the decode step's NaN / Inf guard
  must freeze the slot and the engine must retire it FAILED (never
  streaming garbage tokens).

Every draw comes from one ``numpy.random.RandomState(seed)``, so a chaos
run is a pure function of (arch, seed, workload), as in ``repro``.

``run_chaos`` is the invariant suite (``python -m repro_torch.serve.faults
--seed N``): it drives the engine through the low-level
submit / step / cancel API with randomized deadlines, cancels and injected
faults, then asserts the lifecycle invariants:

1. every submitted request reaches EXACTLY ONE terminal status,
2. the free-page count returns to its initial value (no leaks), the
   block table is all-trash, and no tokens remain in flight,
3. non-faulted finished requests are token-identical to the B=1 batch
   oracle (greedy; preemption-and-recompute must be invisible), and
   partially-served terminals (cancel/timeout) are a PREFIX of the
   oracle's tokens,
4. the numerics health plane (obs/health.py) surfaces every NaN-guard
   trip (``health.nonfinite_dispatches >= anomalies``) and, when any
   anomaly fired, the stock SLO watchdog emitted at least one
   ``anomaly-burst`` alert record (validated in the JSONL output).

The port's additions, for runs on the card: ``device`` (the card unless
the caller names another), ``full`` (published widths and depth instead of
the smoke config), ``params`` (weights to reuse), ``quant`` (the pool's
dtype), ``near_tie`` and ``on_serve``.  On the card the B=1 oracle and
the paged engine lower attention and the MAC differently, so float32
logits differ by ~1e-6 of their scale and a greedy near-tie can flip a
token.  With ``near_tie`` set, invariant 3 then accepts a first differing
token only where the oracle's top-2 logit gap at that position, read from
a teacher-forced prefill of the oracle's own tokens, is under
``near_tie`` times the logit scale, and reports the gap; from there on
the two streams are no longer comparable.  Under an int8 pool, tokens
depend on the pool's history (a recycled page keeps its grown scale), so
invariant 3 keeps only its first half there: no poisoned request
finishes.  ``on_serve`` is called once the oracle has run, just before
the engine (or fleet) serves.

Poisoned pages are safe to recycle in a float pool: prefill packs whole
pages before any position becomes valid, decode overwrites a position
before its validity flips, and the attention mask is a select (masked
lanes drop NaN instead of multiplying by it).  Int8 pools carry the poison
in the page scales (the int8 payload cannot hold a NaN).  A decode write
into a recycled int8 page keeps ``max(old scale, new)``, which stays NaN,
so the page's next owner is retired FAILED at its first step there, as
in ``repro``; a prefill pack writes fresh scales.  The poison is written
in place into the pool tensors the engine's captured decode step reads
(``poison_slot_pages``), so the step is never captured again.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import scheduler as sched_mod


@dataclasses.dataclass
class FaultConfig:
    """Knobs for one seeded injector (all probabilities per event)."""
    seed: int = 0
    alloc_fail_p: float = 0.0          # per PageAllocator.alloc call
    dispatch_delay_p: float = 0.0      # per decode dispatch
    dispatch_delay_s: float = 0.0      # injected sleep when it fires
    corrupt_p: float = 0.0             # per decode dispatch
    # replica-level faults (consulted by fleet.EngineReplica.step)
    crash_p: float = 0.0               # per replica step: hard crash (DOWN)
    hang_p: float = 0.0                # per replica step: wedge the step...
    hang_s: float = 0.0                # ...for this long (heartbeat stalls)


class FaultInjector:
    """Seeded fault source the engine consults at its three seams.

    Wire it with ``ContinuousEngine(..., faults=FaultInjector(cfg))``: the
    engine installs ``alloc_fault`` as the allocator's fault hook and calls
    ``dispatch_delay`` / ``pick_corruption`` before each decode dispatch.
    ``corrupted_ids`` records which request ids were poisoned (the chaos
    suite excludes exactly those from oracle parity).
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self.alloc_failures = 0
        self.delays = 0
        self.corruptions = 0
        self.crashes = 0
        self.hangs = 0
        self.corrupted_ids: set = set()

    def alloc_fault(self, n: int) -> bool:
        """PageAllocator hook: True forces this alloc to fail."""
        if self.cfg.alloc_fail_p <= 0.0:
            return False
        if self.rng.random_sample() < self.cfg.alloc_fail_p:
            self.alloc_failures += 1
            return True
        return False

    def dispatch_delay(self) -> float:
        """Seconds to sleep before the next decode dispatch (0 = none)."""
        if (self.cfg.dispatch_delay_p <= 0.0
                or self.cfg.dispatch_delay_s <= 0.0):
            return 0.0
        if self.rng.random_sample() < self.cfg.dispatch_delay_p:
            self.delays += 1
            return self.cfg.dispatch_delay_s
        return 0.0

    def pick_corruption(self, running: Sequence) -> Optional[object]:
        """A running slot to NaN-poison before this dispatch, or None.
        Each request is poisoned at most once (the guard retires it on the
        very next dispatch, so a second draw would be wasted)."""
        if self.cfg.corrupt_p <= 0.0 or not running:
            return None
        if self.rng.random_sample() >= self.cfg.corrupt_p:
            return None
        slot = running[int(self.rng.randint(len(running)))]
        if slot.request.id in self.corrupted_ids:
            return None
        self.corrupted_ids.add(slot.request.id)
        self.corruptions += 1
        return slot

    def maybe_crash(self) -> bool:
        """Replica hook: True crashes the replica on this step (DOWN)."""
        if self.cfg.crash_p <= 0.0:
            return False
        if self.rng.random_sample() < self.cfg.crash_p:
            self.crashes += 1
            return True
        return False

    def hang_delay(self) -> float:
        """Replica hook: seconds this step wedges for (0 = no hang).  The
        replica's heartbeat stalls, feeding its step-timeout machinery."""
        if self.cfg.hang_p <= 0.0 or self.cfg.hang_s <= 0.0:
            return 0.0
        if self.rng.random_sample() < self.cfg.hang_p:
            self.hangs += 1
            return self.cfg.hang_s
        return 0.0

    def stats(self) -> Dict:
        return {
            "seed": self.cfg.seed,
            "alloc_failures": self.alloc_failures,
            "delays": self.delays,
            "corruptions": self.corruptions,
            "crashes": self.crashes,
            "hangs": self.hangs,
            "corrupted_ids": sorted(self.corrupted_ids),
        }


def poison_slot_pages(pool: Dict[str, torch.Tensor], page: int
                      ) -> Dict[str, torch.Tensor]:
    """NaN-poison one pool page across every layer, IN PLACE; returns the
    pool.

    Float pools poison the K values, int8 pools the K scales (the int8
    payload cannot hold a NaN).  The next attention read over a live
    position of this page gives NaN logits, which the decode step's guard
    turns into a frozen slot and an ``anom`` flag.  Writing into the same
    tensors keeps every address the captured decode step holds."""
    key = "k_scale" if "k_scale" in pool else "k"
    pool[key][:, page] = float("nan")
    return pool


# ---------------------------------------------------------------------------
# Chaos invariant suite (tests/test_torch_faults.py wraps it)
# ---------------------------------------------------------------------------
def make_chaos_workload(n: int, *, vocab: int, seed: int,
                        prompt_lens=(6, 10, 16), budgets=(2, 5, 9, 16),
                        deadline_frac: float = 0.3,
                        deadline_choices=(0.05, 0.4, 5.0)):
    """``n`` requests with randomized prompts and budgets, a
    ``deadline_frac`` fraction carrying (sometimes very tight) deadlines,
    and their arrival times.  Lengths and budgets draw from small sets."""
    from .engine import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        s = int(rng.choice(prompt_lens))
        prompt = rng.randint(1, vocab, size=s).astype(np.int32)
        dl = (float(rng.choice(deadline_choices))
              if rng.random_sample() < deadline_frac else None)
        reqs.append(Request(prompt=prompt, id=i,
                            max_new_tokens=int(rng.choice(budgets)),
                            deadline_s=dl))
    arrivals = np.cumsum(rng.exponential(0.01, size=n)).tolist()
    return reqs, arrivals


def _setup(arch: str, full: bool, params, device):
    """(cfg in float32, params on ``device``, the device)."""
    from ..configs import registry as config_registry
    from ..device import resolve_device
    from ..models.registry import init_params
    getter = config_registry.get_config if full else \
        config_registry.get_smoke_config
    cfg = getter(arch).replace(dtype="float32")
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=0, device=device)
    return cfg, params, device


class _Oracle:
    """The B=1 greedy oracle of a request (no deadline, no faults), and,
    with ``near_tie``, the check of a differing stream against it."""

    def __init__(self, cfg, params, max_seq: int, device,
                 near_tie: Optional[float]):
        from .engine import Engine
        self.cfg, self.params, self.device = cfg, params, device
        self.engine = Engine(cfg, params, max_batch=1, max_seq=max_seq,
                             device=device)
        self.near_tie = near_tie
        self.near_ties: List[Dict] = []

    def tokens(self, reqs) -> Dict[int, List[int]]:
        return {r.id: self.engine.generate(
            [dataclasses.replace(r, deadline_s=None)])[0]["tokens"]
            for r in reqs}

    def gap(self, prompt, want: Sequence[int], i: int):
        """(top-2 logit gap, logit scale) of the oracle at its token ``i``:
        a teacher-forced float32 prefill of the prompt and its first ``i``
        tokens."""
        from ..models.registry import build_model
        from .engine import frontend_inputs
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(want[:i], np.int64)])
        model = build_model(self.cfg)
        with torch.no_grad():
            cache = model.init_cache(1, len(seq), dtype=torch.float32,
                                     device=self.device)
            logits, _ = model.prefill(self.params, {
                "tokens": torch.as_tensor(seq[None], device=self.device),
                **frontend_inputs(self.cfg, 1, self.device)}, cache)
        row = logits[0, -1].float()
        top2 = torch.topk(row, 2).values
        return (float(top2[0] - top2[1]),
                max(1.0, float(row.abs().max())))

    def check(self, req, got: Sequence[int], want: Sequence[int],
              finished: bool) -> Optional[str]:
        """None where ``got`` agrees with ``want`` (equal when finished,
        a prefix otherwise), or diverges first at a near-tie; else why."""
        n = len(got) if not finished else max(len(got), len(want))
        diff = next((i for i in range(n)
                     if i >= len(got) or i >= len(want)
                     or got[i] != want[i]), None)
        if diff is None:
            return None
        what = (f"tokens {list(got)} != oracle {list(want)}" if finished
                else f"prefix {list(got)} != oracle {list(want)}")
        if (self.near_tie is None or diff >= len(got)
                or diff >= len(want)):
            return what
        gap, scale = self.gap(req.prompt, want, diff)
        if gap >= self.near_tie * scale:
            return f"{what} (gap {gap} at token {diff})"
        self.near_ties.append({"id": req.id, "at": diff, "gap": gap,
                               "margin": self.near_tie * scale})
        return None


def run_chaos(arch: str = "tinyllama-1.1b", seed: int = 0,
              requests: int = 24, cancel_p: float = 0.08,
              metrics_out: Optional[str] = None,
              verbose: bool = True, *, device=None, full: bool = False,
              params=None, quant=None, near_tie: Optional[float] = None,
              on_serve: Optional[Callable[[], None]] = None) -> Dict:
    """Drive the continuous engine through randomized lifecycle chaos and
    assert the invariants.  Returns a summary dict (raises AssertionError
    on any violation).  Deterministic given (arch, seed, requests) up to
    the wall clock that deadlines and arrivals read."""
    from ..obs import Obs, SloWatchdog
    from ..quant.codec import QuantPolicy
    from . import kvcache as kvc
    from .engine import ContinuousEngine

    cfg, params, device = _setup(arch, full, params, device)
    quant = quant or QuantPolicy()
    max_seq = 64
    reqs, arrivals = make_chaos_workload(requests, vocab=cfg.vocab_size,
                                         seed=seed)

    oracle_fn = _Oracle(cfg, params, max_seq, device, near_tie)
    oracle = oracle_fn.tokens(reqs)

    faults = FaultInjector(FaultConfig(
        seed=seed, alloc_fail_p=0.05, dispatch_delay_p=0.1,
        dispatch_delay_s=0.002, corrupt_p=0.08))
    # the stock SLO watchdog rides the snapshot cadence: injected NaN
    # poison must surface as anomaly-burst alert records
    watchdog = SloWatchdog()
    obs = (Obs(emit_path=metrics_out, emit_every=5, slo=watchdog)
           if metrics_out else Obs(slo=watchdog))
    # a small pool (half the slots' full-grown footprint) forces organic
    # page pressure on top of the injected allocator failures
    eng = ContinuousEngine(
        cfg, params, max_slots=4, max_seq=max_seq, page_size=8,
        num_pages=9, decode_chunk=4, obs=obs,
        admission="optimistic", max_queue=requests, max_preemptions=4,
        faults=faults, quant=quant, device=device)
    allocator = eng.block_table.allocator
    free0 = allocator.available
    if on_serve is not None:
        on_serve()

    rng = np.random.RandomState(seed + 1)
    orders = {}
    events = 0
    t0 = time.perf_counter()
    for r, a in zip(reqs, arrivals):
        orders[r.id] = eng.submit(r, a)
        events += 1
    live = set(orders)
    steps = 0
    while not eng.scheduler.idle:
        steps += 1
        if not eng.step():
            time.sleep(0.001)          # head of queue hasn't arrived yet
        events += 1
        # randomized cancels against whatever is still live
        live = {i for i in live if eng.result(orders[i]) is None}
        if live and rng.random_sample() < cancel_p:
            target = int(rng.choice(sorted(live)))
            if eng.cancel(target):
                events += 1
        if steps > 50_000:
            raise AssertionError("chaos run did not converge")
    eng.drain()
    wall = time.perf_counter() - t0

    # -- invariant 1: exactly one terminal state per request --------------
    results = {i: eng.result(o) for i, o in orders.items()}
    missing = [i for i, res in results.items() if res is None]
    assert not missing, f"requests with no terminal result: {missing}"
    statuses = {i: res["status"] for i, res in results.items()}
    bad = {i: s for i, s in statuses.items()
           if s not in sched_mod.TERMINAL_STATUSES}
    assert not bad, f"non-terminal statuses: {bad}"
    term_counts = eng.scheduler.terminal_counts()
    assert sum(term_counts.values()) == len(reqs), (
        f"terminal transitions {term_counts} != {len(reqs)} requests "
        f"(a request went terminal twice or never)")

    # -- invariant 2: no page leaks ---------------------------------------
    assert allocator.available == free0, (
        f"page leak: {free0 - allocator.available} pages missing")
    assert allocator.in_use == 0
    assert (eng.block_table.table == 0).all(), "block table not all-trash"
    assert eng.scheduler.tokens_in_flight == 0

    # -- invariant 3: oracle parity for non-faulted requests --------------
    corrupted = faults.corrupted_ids
    mismatches = []
    for r in reqs:
        res = results[r.id]
        finished = res["status"] in sched_mod.FINISHED_STATUSES
        if r.id in corrupted:
            if finished:
                mismatches.append((r.id, "corrupted request FINISHED"))
            continue
        if quant.kv_quantized or not (finished or res["tokens"]):
            continue
        # cancelled / timed-out mid-flight: whatever was produced must
        # still be an oracle prefix (recompute never forks the stream)
        why = oracle_fn.check(r, res["tokens"], oracle[r.id], finished)
        if why is not None:
            mismatches.append((r.id, why))
    assert not mismatches, f"oracle divergence: {mismatches}"

    # -- invariant 4: the numerics health plane saw every guard trip ------
    # a guard retirement and its health.nonfinite_* bump land in the SAME
    # dispatch, so the plane surfaces the anomaly at or before the NaN
    # guard does (one poisoned dispatch can trip several slots' rows,
    # hence >=)
    st = eng.stats()
    anomalies = st["anomalies"]
    health = st.get("health") or {}
    assert health.get("nonfinite_dispatches", 0) >= anomalies, (
        f"health plane missed guard trips: nonfinite_dispatches="
        f"{health.get('nonfinite_dispatches')} < anomalies={anomalies}")
    if anomalies > 0:
        assert watchdog.stats()["by_rule"].get("anomaly-burst", 0) >= 1, (
            f"{anomalies} anomalies but no anomaly-burst alert fired "
            f"(watchdog={watchdog.stats()})")

    if metrics_out:
        from ..obs.emit import validate_jsonl
        counts = validate_jsonl(metrics_out)
        if anomalies > 0:
            assert counts["alert"] >= 1, (
                f"{anomalies} anomalies but no alert record in "
                f"{metrics_out}: {counts}")

    summary = {
        "arch": arch,
        "seed": seed,
        "requests": len(reqs),
        "events": events,
        "steps": steps,
        "statuses": term_counts,
        "preemptions": eng.scheduler.preempted,
        "anomalies": anomalies,
        "health": health,
        "alerts": watchdog.stats(),
        "faults": faults.stats(),
        # the port's additions
        "device": str(device),
        "kv_dtype": quant.kv_dtype,
        "oracle_parity": ("skipped: int8 pool tokens depend on the pool's "
                          "history" if quant.kv_quantized else "checked"),
        "near_ties": oracle_fn.near_ties,
        "decode_graphs": st["decode_graphs"],
        "pool_bytes": kvc.pool_bytes(eng.pool),
        "wall_s": wall,
        "tokens": sum(res["decode_len"] for res in results.values()),
    }
    if verbose:
        print(f"[chaos] seed={seed} arch={arch}: OK — "
              f"{len(reqs)} requests, {events} events, "
              f"statuses={term_counts}, "
              f"preemptions={summary['preemptions']}, "
              f"anomalies={summary['anomalies']}, "
              f"alerts={watchdog.stats()['alerts']}, "
              f"faults={faults.stats()}")
    return summary


# ---------------------------------------------------------------------------
# Fleet chaos: replica crash mid-serving, failover via recompute migration
# ---------------------------------------------------------------------------
def run_fleet_chaos(arch: str = "tinyllama-1.1b", seed: int = 0,
                    requests: int = 16, replicas: int = 2,
                    cancel_p: float = 0.04,
                    metrics_out: Optional[str] = None,
                    verbose: bool = True, *, device=None,
                    full: bool = False, params=None,
                    hang_step_timeout_s: float = 0.003,
                    hang_s: float = 0.004,
                    near_tie: Optional[float] = None,
                    on_serve: Optional[Callable[[], None]] = None) -> Dict:
    """Serve a chaos workload through a replicated fleet, kill one replica
    mid-serving, and assert the fleet-level invariants:

    1. every fleet request reaches EXACTLY ONE terminal status (hedged
       legs, salvaged results, and migrated resubmissions never
       double-settle or drop a request);
    2. zero lost requests: the dead replica's queue entries and running
       slots all resurface as fleet terminals on a survivor;
    3. every SURVIVOR's page pool is fully restored (no leaks; all-trash
       block table; no tokens in flight); the victim's pool is abandoned
       by design;
    4. FINISHED requests are token-identical to the B=1 oracle, including
       requests that migrated across the crash (recompute-prefill on the
       survivor must be invisible), and partial terminals are an oracle
       prefix.  The suite also requires that migration actually happened
       and that at least one MIGRATED request finished.

    The kill is deterministic by construction: once the victim has a
    running slot with generated tokens and the fleet has settled at least
    one request, the victim's ``crash_p`` is armed to 1.0 and its next
    step crashes (the injected-crash path, mid-serving).  One survivor
    carries a seeded hang fault of ``hang_s`` above its step timeout
    ``hang_step_timeout_s`` (``repro``'s 4 and 3 ms by default; a run at
    published widths on the card needs both above a normal step), so the
    DEGRADED / recovery transitions run under load too.  The replicas
    share one ``params``.  On the card every kernel library is built
    before the first replica, so no build lands inside a replica's step.
    """
    from ..fleet import DOWN, EngineReplica, Router
    from ..obs import Obs
    from . import kvcache as kvc
    from .engine import ContinuousEngine

    if replicas < 2:
        raise ValueError("fleet chaos needs >= 2 replicas (one dies)")
    cfg, params, device = _setup(arch, full, params, device)
    if device.type == "cuda":
        from ..kernels import build
        build.build()
    max_seq = 64
    # looser deadlines than single-engine chaos: migrated requests must
    # have room to finish on the survivor, or parity has nothing to bite on
    reqs, arrivals = make_chaos_workload(
        requests, vocab=cfg.vocab_size, seed=seed,
        deadline_frac=0.2, deadline_choices=(0.4, 5.0))

    oracle_fn = _Oracle(cfg, params, max_seq, device, near_tie)
    oracle = oracle_fn.tokens(reqs)

    obs = (Obs(emit_path=metrics_out, emit_every=5)
           if metrics_out else Obs())
    pool = []
    free0: Dict[str, int] = {}
    for i in range(replicas):
        name = f"r{i}"
        # alloc faults keep preemption/recompute hot on every replica;
        # replica 1 also hangs occasionally (hang_s > its step timeout)
        # to drive the DEGRADED <-> HEALTHY transitions under load
        fcfg = FaultConfig(seed=seed * 101 + i, alloc_fail_p=0.05,
                           hang_p=0.03 if i == 1 else 0.0, hang_s=hang_s)
        inj = FaultInjector(fcfg)
        eng = ContinuousEngine(
            cfg, params, max_slots=4, max_seq=max_seq, page_size=8,
            num_pages=9, decode_chunk=4, obs=obs.scoped(replica=name),
            admission="optimistic", max_queue=requests, max_preemptions=4,
            faults=inj, device=device)
        rep = EngineReplica(
            name, eng, faults=inj,
            step_timeout_s=hang_step_timeout_s if i == 1 else 5.0,
            down_after=10 ** 9 if i == 1 else 3, recover_after=2)
        pool.append(rep)
        free0[name] = eng.block_table.allocator.available
    router = Router(pool, policy="jsq", seed=seed, obs=obs)
    victim = pool[0]
    if on_serve is not None:
        on_serve()

    rng = np.random.RandomState(seed + 1)
    orders = {}
    t0 = time.perf_counter()
    for r, a in zip(reqs, arrivals):
        orders[r.id] = router.submit(r, a)
    live = set(orders)
    killed = False
    steps = 0
    while any(router.result(o) is None for o in orders.values()):
        steps += 1
        if not router.step():
            time.sleep(0.001)
        if not killed and victim.state != DOWN:
            mid_serving = any(s.tokens
                              for s in victim.engine.scheduler.running)
            settled = sum(1 for o in orders.values()
                          if router.result(o) is not None)
            if mid_serving and settled >= 1:
                # arm the injected crash: the victim's next step dies with
                # requests running and tokens already generated
                victim.faults.cfg.crash_p = 1.0
                killed = True
        live = {i for i in live if router.result(orders[i]) is None}
        if live and rng.random_sample() < cancel_p:
            router.cancel(int(rng.choice(sorted(live))))
        if steps > 100_000:
            raise AssertionError("fleet chaos did not converge")
    router.drain()
    wall = time.perf_counter() - t0
    assert killed, ("kill never armed: the victim finished its share "
                    "before serving mid-flight (grow the workload)")
    assert victim.state == DOWN and victim.salvaged, (
        f"victim {victim.name} state={victim.state} "
        f"salvaged={victim.salvaged}")
    survivors = [rep for rep in pool if rep is not victim]
    assert all(rep.state != DOWN for rep in survivors), (
        f"survivor died: {[rep.stats() for rep in survivors]}")

    # -- invariant 1: exactly one terminal per fleet request --------------
    results = {i: router.result(o) for i, o in orders.items()}
    missing = [i for i, res in results.items() if res is None]
    assert not missing, f"lost requests (no terminal): {missing}"
    bad = {i: res["status"] for i, res in results.items()
           if res["status"] not in sched_mod.TERMINAL_STATUSES}
    assert not bad, f"non-terminal statuses: {bad}"
    term_counts = router.terminal_counts()
    assert sum(term_counts.values()) == len(reqs), (
        f"fleet terminal transitions {term_counts} != {len(reqs)} "
        f"requests (double-settle or drop)")

    # -- invariant 2: survivors' pools fully restored ---------------------
    for rep in survivors:
        alloc = rep.engine.block_table.allocator
        assert alloc.available == free0[rep.name], (
            f"{rep.name}: page leak "
            f"({free0[rep.name] - alloc.available} pages missing)")
        assert alloc.in_use == 0, rep.name
        assert (rep.engine.block_table.table == 0).all(), (
            f"{rep.name}: block table not all-trash")
        assert rep.engine.scheduler.tokens_in_flight == 0, rep.name

    # -- invariant 3: migration happened and finished ---------------------
    migrated = {i for i, res in results.items() if res["migrations"] > 0}
    assert migrated, "replica died mid-serving but nothing migrated"
    migrated_finished = {
        i for i in migrated
        if results[i]["status"] in sched_mod.FINISHED_STATUSES}
    assert migrated_finished, (
        f"no migrated request finished (migrated={sorted(migrated)}, "
        f"statuses={ {i: results[i]['status'] for i in migrated} })")

    # -- invariant 4: oracle parity, including across the migration -------
    corrupted = set()
    for rep in pool:
        corrupted |= rep.engine.faults.corrupted_ids if rep.engine.faults \
            else set()
    mismatches = []
    for r in reqs:
        if r.id in corrupted:
            continue
        res = results[r.id]
        finished = res["status"] in sched_mod.FINISHED_STATUSES
        if not (finished or res["tokens"]):
            continue
        why = oracle_fn.check(r, res["tokens"], oracle[r.id], finished)
        if why is not None:
            mismatches.append((r.id, res["migrations"], why))
    assert not mismatches, f"oracle divergence: {mismatches}"

    if metrics_out:
        from ..obs.emit import validate_jsonl
        validate_jsonl(metrics_out)

    tokens = sum(res["decode_len"] for res in results.values())
    summary = {
        "arch": arch,
        "seed": seed,
        "requests": len(reqs),
        "replicas": replicas,
        "steps": steps,
        "statuses": term_counts,
        "migrated": sorted(migrated),
        "migrated_finished": sorted(migrated_finished),
        "router": router.stats(),
        # the port's additions
        "device": str(device),
        "faults": {rep.name: rep.faults.stats() for rep in pool},
        "near_ties": oracle_fn.near_ties,
        # migrated requests' oracle parity at the first differing token
        "migrated_near_ties": [t for t in oracle_fn.near_ties
                               if t["id"] in migrated_finished],
        "abandoned_pool_bytes": kvc.pool_bytes(victim.engine.pool),
        "wall_s": wall,
        "tokens": tokens,
        "tokens_per_s": tokens / max(wall, 1e-9),
    }
    if verbose:
        rs = summary["router"]
        print(f"[fleet-chaos] seed={seed} arch={arch}: OK — "
              f"{len(reqs)} requests over {replicas} replicas, "
              f"victim={victim.name} down ({victim.down_reason}), "
              f"statuses={term_counts}, migrated={sorted(migrated)}, "
              f"hedges={rs['hedges']}, shed={rs['shed']}")
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Chaos invariant suites (seeded fault injection) on "
                    "the CUDA card unless --device names another.")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=None,
                    help="workload size (default: 24 single-engine, "
                         "16 fleet)")
    ap.add_argument("--fleet", action="store_true",
                    help="run the replicated-fleet chaos suite (replica "
                         "crash + failover migration) instead of the "
                         "single-engine suite")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size for --fleet (one replica is killed)")
    ap.add_argument("--metrics-out", default=None,
                    help="also emit obs JSONL and validate it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        if args.fleet:
            run_fleet_chaos(arch=args.arch, seed=args.seed,
                            requests=(16 if args.requests is None
                                      else args.requests),
                            replicas=args.replicas,
                            metrics_out=args.metrics_out,
                            device=args.device)
        else:
            run_chaos(arch=args.arch, seed=args.seed,
                      requests=(24 if args.requests is None
                                else args.requests),
                      metrics_out=args.metrics_out, device=args.device)
    except AssertionError as e:
        print(f"[chaos] FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
