"""The port's fleet (``fleet/router.py``, ``fleet/replica.py``) against
``repro``'s: one host-only fake replica class drives both packages'
``Router``s on the same virtual clock and seed, and the event traces
(placements, retries with backoff, sheds, hedges and their winners,
failover with salvage, terminal results, ``stats()``) must be equal;
``EngineReplica``'s health machine under injected crash and hang against
``repro``'s; and a real-engine failover on converted weights whose
migrated requests give ``repro``'s B=1 tokens."""
import collections
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.fleet as jfleet  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.obs import Obs as JObs  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs import Obs as TObs  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402

PKGS = {"repro": (jfleet, JObs, jeng, jfaults),
        "port": (tfleet, TObs, teng, tfaults)}


def req(em, rid, new=4, prompt_len=4, deadline_s=None, priority=0):
    return em.Request(prompt=np.arange(prompt_len, dtype=np.int32) + 1,
                      max_new_tokens=new, id=rid, deadline_s=deadline_s,
                      priority=priority)


# ---------------------------------------------------------------------------
# one fake replica class for both routers
# ---------------------------------------------------------------------------
class FakeReplica:
    """Host-only replica honouring the Router's interface (``repro``'s
    test fake), logging every call the router makes.

    One token per step per running job (token i is always 100 + i, so a
    migrated, hedged or resumed stream that finishes is prefix-closed);
    ``capacity`` running slots and a ``max_queue``-bounded wait queue;
    ``stalled`` replicas admit but never emit."""

    def __init__(self, fleet, log, name, capacity=2, max_queue=8,
                 stalled=False):
        self.fleet, self.log = fleet, log
        self.name = name
        self.state = fleet.HEALTHY
        self.salvaged = False
        self.capacity = capacity
        self.max_queue = max_queue
        self.stalled = stalled
        self._next = 0
        self.jobs = {}
        self.run = []
        self.wait = []
        self.results = {}
        self.cancels = 0

    @property
    def live(self):
        return self.state != self.fleet.DOWN

    @property
    def load(self):
        return len(self.jobs)

    @property
    def max_seq(self):
        return None

    def submit(self, request, arrival_s=0.0, resume_tokens=None,
               preemptions=0):
        if not self.live:
            return -1, False
        local = self._next
        self._next += 1
        ok = len(self.wait) < self.max_queue
        self.log.append(("submit", self.name, request.id, local,
                         list(resume_tokens or []), preemptions, ok))
        if not ok:
            return local, False
        self.jobs[local] = {"req": request,
                            "tokens": list(resume_tokens or []),
                            "resume0": len(resume_tokens or []),
                            "budget": request.max_new_tokens,
                            "preempts": preemptions}
        self.wait.append(local)
        return local, True

    def step(self):
        if not self.live:
            return False
        progress = False
        while self.wait and len(self.run) < self.capacity:
            self.run.append(self.wait.pop(0))
            progress = True
        if self.stalled:
            return progress
        for local in list(self.run):
            job = self.jobs[local]
            job["tokens"].append(100 + len(job["tokens"]))
            progress = True
            if len(job["tokens"]) >= job["budget"]:
                self._finish(local, "FINISHED_BUDGET")
        return progress

    def _finish(self, local, status):
        job = self.jobs.pop(local)
        if local in self.run:
            self.run.remove(local)
        if local in self.wait:
            self.wait.remove(local)
        served = len(job["tokens"]) > job["resume0"] or status.startswith(
            "FINISHED")
        self.results[local] = {
            "id": job["req"].id, "tokens": list(job["tokens"]),
            "decode_len": len(job["tokens"]), "status": status,
            "preemptions": job["preempts"], "tokens_per_s": 0.0,
            "prefill_s": 0.01 * (1 + local) if served else None,
            "decode_s": 0.0, "queue_s": 0.002 * local if served else None,
            "latency_s": 0.0,
        }

    def result(self, local, pop=False):
        res = (self.results.pop(local, None) if pop
               else self.results.get(local))
        if res is not None:
            self.log.append(("result", self.name, local, pop,
                             res["status"]))
        return res

    def cancel(self, request_id):
        if not self.live:
            return False
        for local, job in list(self.jobs.items()):
            if job["req"].id == request_id:
                self.cancels += 1
                self.log.append(("cancel", self.name, request_id, local))
                self._finish(local, "CANCELLED")
                return True
        return False

    def first_token_seen(self, local):
        job = self.jobs.get(local)
        if job is not None:
            return len(job["tokens"]) > job["resume0"]
        return local in self.results

    def drain(self):
        self.stalled = False
        while self.jobs:
            self.step()
        return []

    def force_crash(self, reason="forced crash"):
        self.log.append(("crash", self.name))
        self.state = self.fleet.DOWN

    def salvage(self):
        if self.state != self.fleet.DOWN:
            raise RuntimeError("salvage on a live fake")
        if self.salvaged:
            return self.fleet.Salvage({}, [])
        self.salvaged = True
        results, self.results = self.results, {}
        lost = [self.fleet.LostRequest(job["req"], list(job["tokens"]),
                                       job["preempts"], local)
                for local, job in sorted(self.jobs.items())]
        self.log.append(("salvage", self.name, sorted(results),
                         [(lr.local_order, lr.resume_tokens) for lr in lost]))
        self.jobs.clear()
        self.run, self.wait = [], []
        return self.fleet.Salvage(results, lost)

    def stats(self):
        return {"name": self.name, "state": self.state,
                "cancels": self.cancels}


# Scenarios: replicas (name, kwargs), router kwargs, then a script of
# actions: ("submit", request kwargs[, arrival]), ("step", n),
# ("advance", seconds), ("crash", name), ("cancel", id), ("set", name,
# attribute, value), ("drain",), ("generate", [request kwargs]).
SCENARIOS = {
    "jsq": ([("r0", {}), ("r1", {}), ("r2", {"capacity": 1})], {},
            [("submit", dict(rid=i, new=2 + i % 3)) for i in range(7)]
            + [("step", 8)]),
    "round_robin": ([("r0", {}), ("r1", {}), ("r2", {})],
                    {"policy": "round_robin"},
                    [("submit", dict(rid=i, new=3)) for i in range(8)]
                    + [("step", 6)]),
    "retry_backoff": ([("r0", {"max_queue": 0}), ("r1", {"max_queue": 0})],
                      {"backoff_base_s": 0.01, "backoff_cap_s": 0.1},
                      [("submit", dict(rid=0)), ("submit", dict(rid=1)),
                       ("step", 1), ("advance", 0.015), ("step", 1),
                       ("advance", 0.05), ("step", 1),
                       ("set", "r1", "max_queue", 4), ("advance", 0.3),
                       ("step", 6)]),
    "overflow_priority": ([("r0", {"max_queue": 0})], {"max_pending": 3},
                          [("submit", dict(rid=0, priority=5)),
                           ("submit", dict(rid=1, priority=3)),
                           ("submit", dict(rid=2, priority=0)),
                           ("submit", dict(rid=3, priority=3)),
                           ("submit", dict(rid=4, priority=9)),
                           ("submit", dict(rid=5, priority=1)),
                           ("set", "r0", "max_queue", 8), ("advance", 1.0),
                           ("step", 6)]),
    "deadline_shed": ([("r0", {"max_queue": 0})], {},
                      [("submit", dict(rid=0, deadline_s=0.1)),
                       ("submit", dict(rid=1, deadline_s=5.0)),
                       ("submit", dict(rid=2)), ("advance", 1.0),
                       ("step", 1), ("set", "r0", "max_queue", 8),
                       ("advance", 0.5), ("step", 5)]),
    "hedge_explicit": ([("r0", {"stalled": True}), ("r1", {})],
                       {"hedge_after_s": 0.1},
                       [("submit", dict(rid=0, new=3)),
                        ("submit", dict(rid=1, new=2)), ("step", 1),
                        ("advance", 0.5), ("step", 1), ("step", 6)]),
    "hedge_adaptive": ([("r0", {}), ("r1", {"capacity": 1})],
                       {"hedge_min_samples": 4, "hedge_min_s": 0.01},
                       [("submit", dict(rid=i, new=2)) for i in range(6)]
                       + [("step", 4), ("set", "r0", "stalled", True),
                          ("submit", dict(rid=6, new=3)),
                          ("submit", dict(rid=7, new=3)), ("step", 1),
                          ("advance", 2.0), ("step", 1),
                          ("set", "r0", "stalled", False), ("step", 8)]),
    "failover_salvage": ([("r0", {"capacity": 1}), ("r1", {"capacity": 1}),
                          ("r2", {"max_queue": 1})], {},
                         [("submit", dict(rid=0, new=6)),
                          ("submit", dict(rid=1, new=2)),
                          ("submit", dict(rid=2, new=5)),
                          ("submit", dict(rid=3, new=1)),
                          ("submit", dict(rid=4, new=4)), ("step", 2),
                          ("crash", "r0"), ("step", 10)]),
    "cancel_and_down": ([("r0", {"max_queue": 0}), ("r1", {})], {},
                        [("submit", dict(rid=0, new=8)),
                         ("submit", dict(rid=1, new=8)), ("step", 1),
                         ("cancel", 0), ("cancel", 7), ("step", 2),
                         ("crash", "r1"), ("step", 2), ("crash", "r0"),
                         ("submit", dict(rid=2)), ("step", 1)]),
    "drain_closed_intake": ([("r0", {}), ("r1", {})], {},
                            [("submit", dict(rid=0, new=3)),
                             ("submit", dict(rid=1, new=5)), ("drain",),
                             ("submit", dict(rid=2))]),
    "generate": ([("r0", {}), ("r1", {"capacity": 1})], {"seed": 3},
                 [("generate", [dict(rid=i, new=2 + i % 3)
                                for i in range(6)])]),
}


def _run(pkg, scenario):
    fleet, Obs, em, _ = PKGS[pkg]
    reps, kw, script = SCENARIOS[scenario]
    log = []
    replicas = {name: FakeReplica(fleet, log, name, **rkw)
                for name, rkw in reps}
    now = [0.0]
    router = fleet.Router(list(replicas.values()), obs=Obs(),
                          clock=lambda: now[0], **kw)
    orders = []
    for action in script:
        op = action[0]
        if op == "submit":
            orders.append(router.submit(req(em, **action[1]),
                                        *action[2:]))
        elif op == "step":
            for _ in range(action[1]):
                log.append(("router_step", router.step(), now[0]))
        elif op == "advance":
            now[0] += action[1]
        elif op == "crash":
            replicas[action[1]].force_crash()
        elif op == "cancel":
            log.append(("router_cancel", action[1],
                        router.cancel(action[1])))
        elif op == "set":
            setattr(replicas[action[1]], action[2], action[3])
        elif op == "drain":
            log.append(("drained", [r["id"] for r in router.drain()]))
        elif op == "generate":
            log.append(("generated", router.generate(
                [req(em, **r) for r in action[1]])))
    results = {o: router.result(o) for o in orders}
    return (log, results, router.stats(), router.terminal_counts(),
            sorted((p.order, p.retries, p.next_try_s)
                   for p in router._pending))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_trace_matches_repro(scenario):
    want, got = _run("repro", scenario), _run("port", scenario)
    assert got == want


def test_router_scenarios_bite():
    """The scenarios reach what they are named after (on the port)."""
    def stats(name):
        return _run("port", name)[2]
    assert stats("retry_backoff")["place_retries"] >= 2
    assert stats("overflow_priority")["shed"]["overflow"] == 3
    assert stats("deadline_shed")["shed"]["deadline"] == 1
    assert stats("hedge_explicit")["hedge_wins"]["hedge"] == 1
    assert stats("hedge_adaptive")["hedges"] >= 1
    fo = stats("failover_salvage")
    assert fo["failovers"] == 1 and fo["migrated_requests"] >= 1
    down = stats("cancel_and_down")
    assert down["shed"]["no_live_replicas"] == 2   # migrated + fresh
    log, results, _, _, _ = _run("port", "failover_salvage")
    migrated = [r for r in results.values() if r["migrations"]]
    assert migrated and all(r["tokens"] == [100 + i for i in range(
        len(r["tokens"]))] for r in migrated)


def test_router_refusals():
    with pytest.raises(ValueError, match="at least one"):
        tfleet.Router([])
    log = []
    r0 = FakeReplica(tfleet, log, "r0")
    with pytest.raises(ValueError, match="unique"):
        tfleet.Router([r0, FakeReplica(tfleet, log, "r0")])
    with pytest.raises(ValueError, match="policy"):
        tfleet.Router([r0], policy="random")


# ---------------------------------------------------------------------------
# EngineReplica's health machine
# ---------------------------------------------------------------------------
class FakeEngine:
    """The slice of ContinuousEngine that EngineReplica touches."""

    def __init__(self, Obs):
        self.obs = Obs()
        self.anomalies = 0
        self._results = {}
        self._traces = {}
        self.step_fn = lambda: True
        self.max_seq = None

        class _Sched:
            queue_depth = 0
            running = ()
            queue = collections.deque()

            def drain_doomed(self):
                return []

            def close_intake(self):
                pass

        self.scheduler = _Sched()

    def step(self):
        return self.step_fn()

    def stats(self):
        return {}


def _ticking_clock(step):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def _health_trace(pkg):
    """One script through the health machine: timeouts, anomalies,
    recovery, an injected hang and crash; the states and counters seen."""
    fleet, Obs, _, faults = PKGS[pkg]
    out = []
    slow = fleet.EngineReplica("r0", FakeEngine(Obs), step_timeout_s=1.0,
                               down_after=3, clock=_ticking_clock(1.1))
    for _ in range(4):
        out.append((slow.step(), slow.state, slow.consecutive_timeouts))
    out.append(slow.stats())
    eng = FakeEngine(Obs)
    rep = fleet.EngineReplica("r1", eng, step_timeout_s=10.0,
                              recover_after=2, clock=_ticking_clock(0.001))
    for anomalies in (0, 2, 2, 2, 3, 3, 3):
        eng.anomalies = anomalies
        rep.step()
        out.append((rep.state, rep._clean_steps))
    crash = faults.FaultInjector(faults.FaultConfig(seed=0, crash_p=0.3))
    rep = fleet.EngineReplica("r2", FakeEngine(Obs), faults=crash,
                              clock=_ticking_clock(0.001))
    while rep.state != fleet.DOWN:
        out.append(rep.step())
    out.append((rep.down_reason, crash.stats(), rep.stats()))
    hang = faults.FaultInjector(faults.FaultConfig(seed=1, hang_p=0.5,
                                                   hang_s=0.003))
    rep = fleet.EngineReplica("r3", FakeEngine(Obs), faults=hang,
                              step_timeout_s=0.002, down_after=100,
                              recover_after=2)
    for _ in range(8):
        rep.step()
        out.append(rep.state)
    out.append((hang.stats()["hangs"], rep.stats()["step_timeouts"]))
    return out


def test_health_machine_matches_repro():
    got, want = _health_trace("port"), _health_trace("repro")
    assert got == want
    # the hang replica: one timeout per injected hang, no other
    assert got[-1][0] == got[-1][1] >= 1


def test_health_exception_is_a_crash_and_salvage_once():
    eng = FakeEngine(TObs)
    eng.step_fn = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    rep = tfleet.EngineReplica("r0", eng)
    assert not rep.step()
    assert rep.state == tfleet.DOWN and "device lost" in rep.down_reason
    assert rep.submit(req(teng, 0)) == (-1, False)
    eng2 = FakeEngine(TObs)
    rep2 = tfleet.EngineReplica("r1", eng2)
    with pytest.raises(RuntimeError, match="only DOWN"):
        rep2.salvage()
    eng2._results[0] = {"status": "FINISHED_BUDGET", "id": 0}
    eng2.scheduler.queue.append(types.SimpleNamespace(
        request=req(teng, 1), resume_tokens=[7], preemptions=1, order=1))
    eng2.scheduler.running = (types.SimpleNamespace(
        request=req(teng, 2), tokens=[5, 6], preemptions=0, order=2),)
    rep2.force_crash("test kill")
    salvage = rep2.salvage()
    assert set(salvage.results) == {0}
    assert [(lr.local_order, lr.resume_tokens) for lr in salvage.lost] == \
        [(1, [7]), (2, [5, 6])]
    again = rep2.salvage()
    assert not again.results and not again.lost


# ---------------------------------------------------------------------------
# real engines: failover on converted weights against repro's B=1 oracle
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    tcfg = tget("tinyllama-1.1b").replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


def _tiny_reqs(em, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [em.Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                       max_new_tokens=n, id=i)
            for i, (s, n) in enumerate(specs)]


SPECS = [(12, 10), (10, 12), (14, 9), (9, 11), (11, 10), (13, 8)]


def test_fleet_failover_gives_repro_oracle_tokens(tiny_setup):
    """Kill a replica mid-serving; every finished request, the migrated
    ones included, carries ``repro``'s B=1 tokens."""
    cfg, tcfg, params, model = tiny_setup
    oracle = jeng.Engine(cfg, params, max_batch=1, max_seq=32)
    want = [oracle.generate([r])[0]["tokens"]
            for r in _tiny_reqs(jeng, SPECS)]
    root = TObs()
    pool = [tfleet.EngineReplica(
        f"r{i}", teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=32,
                                       page_size=4, decode_chunk=3,
                                       obs=root.scoped(replica=f"r{i}"),
                                       device="cpu"))
        for i in range(2)]
    router = tfleet.Router(pool, seed=0, obs=root)
    orders = [router.submit(r) for r in _tiny_reqs(teng, SPECS)]
    victim, survivor = pool
    free0 = survivor.engine.block_table.allocator.available
    killed, guard = False, 0
    while any(router.result(o) is None for o in orders):
        guard += 1
        assert guard < 5000, "fleet run did not converge"
        router.step()
        if not killed and any(s.tokens
                              for s in victim.engine.scheduler.running):
            victim.force_crash("test kill")
            killed = True
    assert killed and victim.salvaged
    results = [router.result(o) for o in orders]
    assert any(r["migrations"] > 0 for r in results)
    for res, toks in zip(results, want):
        assert res["status"] in ("FINISHED_EOS", "FINISHED_BUDGET"), res
        assert res["tokens"] == toks, (res, toks)
    assert survivor.engine.block_table.allocator.available == free0
    assert survivor.engine.scheduler.tokens_in_flight == 0
    assert sum(router.terminal_counts().values()) == len(SPECS)
    st = router.stats()
    assert st["failovers"] == 1 and st["live_replicas"] == 1
    assert [r["step_timeouts"] for r in st["replicas"]] == [0, 0]


def test_two_live_engines_metrics_isolation(tiny_setup):
    """Two engines share one registry through scoped views: every series
    carries its replica label and each engine's stats() read its own."""
    _, tcfg, _, model = tiny_setup
    root = TObs()
    engs = [teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=32,
                                  page_size=4, decode_chunk=4,
                                  obs=root.scoped(replica=f"e{i}"),
                                  device="cpu")
            for i in range(2)]
    reqs = _tiny_reqs(teng, [(8, 3), (10, 4), (9, 2), (12, 5)])
    for i, eng in enumerate(engs):
        for r in reqs[2 * i:2 * i + 2]:
            eng.submit(r)
    while not all(e.scheduler.idle for e in engs):
        for eng in engs:
            eng.step()
    reg = root.registry
    for i, eng in enumerate(engs):
        assert reg.value("sched.submitted", replica=f"e{i}") == 2
        assert eng.stats()["retired"] == 2
    with pytest.raises(KeyError):
        reg.value("sched.submitted")
    done = list(root.traces.completed)
    assert {(t.replica, t.order) for t in done} == {
        ("e0", 0), ("e0", 1), ("e1", 0), ("e1", 1)}


def test_launcher_replicas(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tinyllama-1.1b", "--engine", "continuous",
                      "--device", "cpu", "--replicas", "2", "--requests",
                      "4", "--new-tokens", "4", "--router-policy",
                      "round_robin", "--max-preemptions", "2",
                      "--admission", "reserve", "--max-queue", "8",
                      "--max-tokens-in-flight", "200", "--deadline-s",
                      "30"])
    text = capsys.readouterr().out
    assert "(continuous x2) on cpu: 4 requests, 16 tokens" in text
    line = next(ln for ln in text.splitlines()
                if ln.startswith("[launch.serve] fleet:"))
    assert "policy=round_robin live=2/2 placed=4" in line
    assert "statuses={'FINISHED_BUDGET': 4}" in line
    assert sum(ln.startswith("[launch.serve]   r") for ln in
               text.splitlines()) == 2
    assert out["stats"]["placed"] == 4
    with pytest.raises(SystemExit, match="requires --engine continuous"):
        serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--replicas", "2"])


def test_launcher_engine_flags(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tinyllama-1.1b", "--engine", "continuous",
                      "--device", "cpu", "--requests", "3",
                      "--new-tokens", "3", "--no-precompute",
                      "--max-queue", "2", "--no-obs"])
    statuses = [r["status"] for r in out["results"]]
    assert statuses.count("REJECTED") == 1          # the bounded queue
    assert out["stats"]["admission"] == "optimistic"
