"""Fault injection in the port (``serve/faults.py``, ``ContinuousEngine(
faults=)``, ``PageAllocator(fault=)``) against ``repro``'s: the injector's
draws and stats, the chaos workload, and, on the same weights with every
request submitted before the first step and no wall-clock input (no
dispatch delays, no deadlines), the same terminal statuses, tokens and
fault stats from both engines; then the port's own chaos and fleet-chaos
suites at the smoke config."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant.codec import QuantPolicy as TPolicy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

ARCH = "tinyllama-1.1b"
# run_chaos's engine, as repro's suite builds it
CHAOS_ENGINE = dict(max_slots=4, max_seq=64, page_size=8, num_pages=9,
                    decode_chunk=4, admission="optimistic",
                    max_preemptions=4)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


# ---------------------------------------------------------------------------
# the injector and the workload
# ---------------------------------------------------------------------------
class _Slot:
    def __init__(self, rid):
        self.request = teng.Request(prompt=np.array([1], np.int32),
                                    max_new_tokens=1, id=rid)


def _roll(mod, cfg):
    """A fixed call sequence over every hook; (results, stats)."""
    inj = mod.FaultInjector(mod.FaultConfig(**cfg))
    slots = [_Slot(i) for i in range(5)]
    out = []
    for i in range(60):
        out.append(inj.alloc_fault(1 + i % 3))
        out.append(inj.dispatch_delay())
        picked = inj.pick_corruption(slots[:1 + i % 5])
        out.append(None if picked is None else picked.request.id)
        out.append(inj.maybe_crash())
        out.append(inj.hang_delay())
    return out, inj.stats()


@pytest.mark.parametrize("cfg", [
    dict(seed=0, alloc_fail_p=0.05, dispatch_delay_p=0.1,
         dispatch_delay_s=0.002, corrupt_p=0.08),
    dict(seed=3, alloc_fail_p=0.3, dispatch_delay_p=0.3,
         dispatch_delay_s=0.01, corrupt_p=0.5, crash_p=0.1, hang_p=0.2,
         hang_s=0.004),
    dict(seed=7, corrupt_p=1.0, hang_p=0.5),          # hang_s 0: no draws
    dict(seed=1),
])
def test_injector_draws_and_stats_match_repro(cfg):
    assert _roll(tfaults, cfg) == _roll(jfaults, cfg)


def test_injector_deterministic_and_corrupts_each_request_once():
    cfg = dict(seed=3, alloc_fail_p=0.3, corrupt_p=0.5)
    assert _roll(tfaults, cfg) == _roll(tfaults, cfg)
    assert _roll(tfaults, cfg) != _roll(tfaults, dict(cfg, seed=4))
    inj = tfaults.FaultInjector(tfaults.FaultConfig(seed=0, corrupt_p=1.0))
    s0, s1 = _Slot(0), _Slot(1)
    first = inj.pick_corruption([s0, s1])
    assert first in (s0, s1)
    assert inj.pick_corruption([first]) is None     # once per request id
    other = s1 if first is s0 else s0
    assert inj.pick_corruption([other]) is other
    assert inj.stats()["corrupted_ids"] == [0, 1]


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_workload_matches_repro(seed, fleet):
    kw = (dict(deadline_frac=0.2, deadline_choices=(0.4, 5.0)) if fleet
          else {})
    want, want_arr = jfaults.make_chaos_workload(24, vocab=500, seed=seed,
                                                 **kw)
    got, got_arr = tfaults.make_chaos_workload(24, vocab=500, seed=seed,
                                               **kw)
    assert got_arr == want_arr and got_arr == sorted(got_arr)
    for a, b in zip(got, want):
        assert (a.id, a.max_new_tokens, a.deadline_s, a.priority) == (
            b.id, b.max_new_tokens, b.deadline_s, b.priority)
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ---------------------------------------------------------------------------
# the seams
# ---------------------------------------------------------------------------
def test_allocator_fault_hook():
    calls = []

    def fault(n):
        calls.append(n)
        return len(calls) == 2

    alloc = tkv.PageAllocator(6, fault=fault)
    assert alloc.alloc(2) == [1, 2]
    assert alloc.alloc(1) is None                   # injected: as if empty
    assert alloc.available == 3 and alloc.alloc(1) == [3]
    assert alloc.alloc(9) is None and calls == [2, 1, 1]   # not consulted


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_poison_is_in_place(setup, kv_dtype):
    _, tcfg, _, _ = setup
    pool = tkv.build_pool(tcfg, 5, 8, TPolicy(kv_dtype), device="cpu")
    key = "k_scale" if kv_dtype == "int8" else "k"
    ptrs = {k: t.data_ptr() for k, t in pool.items()}
    out = tfaults.poison_slot_pages(pool, 3)
    assert out is pool
    assert {k: t.data_ptr() for k, t in pool.items()} == ptrs
    assert torch.isnan(pool[key][:, 3]).all()
    others = [p for p in range(5) if p != 3]
    assert not torch.isnan(pool[key][:, others].float()).any()
    for k in pool:
        if k != key:
            assert not torch.isnan(pool[k].float()).any(), k


def test_request_priority_and_engine_without_faults(setup):
    _, tcfg, _, model = setup
    assert teng.Request(prompt=np.ones(3, np.int32)).priority == 0
    eng = teng.ContinuousEngine(tcfg, model, device="cpu", max_seq=32,
                                page_size=8)
    assert eng.faults is None and eng.block_table.allocator.fault is None


# ---------------------------------------------------------------------------
# the deterministic comparison against repro
# ---------------------------------------------------------------------------
def _serve(eng, reqs):
    """Every request submitted before the first step, then steps to idle;
    results by request id."""
    orders = {r.id: eng.submit(r, 0.0) for r in reqs}
    steps = 0
    while not eng.scheduler.idle:
        eng.step()
        steps += 1
        assert steps < 5000, "did not converge"
    return {i: eng.result(o) for i, o in orders.items()}


def _chaos_pair(setup, seed, kv_dtype="f32", n=24):
    cfg, tcfg, params, model = setup
    fc = dict(seed=seed, alloc_fail_p=0.05, corrupt_p=0.08)
    reqs, _ = jfaults.make_chaos_workload(n, vocab=cfg.vocab_size,
                                          seed=seed)
    out = []
    for mod, em, c, p, extra in (
            (jfaults, jeng, cfg, params, dict(quant=JPolicy(kv_dtype))),
            (tfaults, teng, tcfg, model, dict(device="cpu",
                                              quant=TPolicy(kv_dtype)))):
        faults = mod.FaultInjector(mod.FaultConfig(**fc))
        eng = em.ContinuousEngine(c, p, faults=faults, max_queue=n,
                                  **CHAOS_ENGINE, **extra)
        res = _serve(eng, [em.Request(prompt=r.prompt, id=r.id,
                                      max_new_tokens=r.max_new_tokens)
                           for r in reqs])
        out.append(({i: (r["status"], list(r["tokens"]))
                     for i, r in res.items()}, faults.stats(),
                    eng.stats()["anomalies"], eng.scheduler.preempted))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_engine_matches_repro(setup, seed):
    """Equal terminal statuses and tokens, equal ``faults.stats()`` (every
    allocator and corruption draw at the same point), equal anomalies and
    preemptions."""
    want, got = _chaos_pair(setup, seed)
    assert got == want
    statuses, stats, anomalies, preempted = got
    ends = [status for status, _ in statuses.values()]
    # the run bites: poisoned slots FAILED, preemptions, finished requests
    assert ends.count("FAILED") == anomalies == stats["corruptions"] >= 1
    assert preempted > 0 and "FINISHED_BUDGET" in ends


def test_int8_poisoned_page_recycled_matches_repro(setup):
    """An int8 page whose K scale was poisoned goes back to the free list.
    A prefill pack writes the page's scales afresh; a decode write keeps
    max(old scale, new), which stays NaN, so a later request that grows
    into the page by decode is retired FAILED by the guard, in ``repro``
    as in the port.  One slot, page 4: A (4 + 4 tokens) is poisoned at
    its first dispatch and fails; B (4 tokens of prompt) prefills into the
    page A's decode grew into and grows by decode into A's first, the
    poisoned one."""
    cfg, tcfg, params, model = setup
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 500, size=4).astype(np.int32) for _ in "AB"]
    out = []
    for mod, em, c, p, extra in (
            (jfaults, jeng, cfg, params, dict(quant=JPolicy("int8"))),
            (tfaults, teng, tcfg, model, dict(device="cpu",
                                              quant=TPolicy("int8")))):
        faults = mod.FaultInjector(mod.FaultConfig(seed=0, corrupt_p=1.0))
        eng = em.ContinuousEngine(c, p, faults=faults, max_slots=1,
                                  max_seq=16, page_size=4, num_pages=6,
                                  decode_chunk=2, **extra)
        a = _serve(eng, [em.Request(prompt=prompts[0], id=0,
                                    max_new_tokens=4)])[0]
        faults.cfg.corrupt_p = 0.0                   # poison A only
        b = _serve(eng, [em.Request(prompt=prompts[1], id=1,
                                    max_new_tokens=6)])[1]
        out.append(((a["status"], list(a["tokens"])),
                    (b["status"], list(b["tokens"])), faults.stats()))
    assert out[1] == out[0]
    (a_status, _), (b_status, b_tokens), st = out[1]
    assert a_status == "FAILED" and st["corrupted_ids"] == [0]
    assert b_status == "FAILED" and len(b_tokens) < 6


# ---------------------------------------------------------------------------
# the port's suites at the smoke config
# ---------------------------------------------------------------------------
def test_chaos_suite_smoke(tmp_path):
    out = str(tmp_path / "chaos.jsonl")
    summary = tfaults.run_chaos(seed=0, requests=10, metrics_out=out,
                                verbose=False, device="cpu")
    assert summary["requests"] == 10
    assert sum(summary["statuses"].values()) == 10
    assert summary["decode_graphs"] == 0            # eager on the CPU
    assert summary["near_ties"] == []


def test_chaos_suite_int8_pool():
    summary = tfaults.run_chaos(seed=1, requests=10, verbose=False,
                                device="cpu", quant=TPolicy("int8"))
    assert summary["kv_dtype"] == "int8"
    assert summary["oracle_parity"].startswith("skipped")
    assert sum(summary["statuses"].values()) == 10


def test_fleet_chaos_smoke(tmp_path):
    out = str(tmp_path / "fleet_chaos.jsonl")
    summary = tfaults.run_fleet_chaos(seed=0, requests=10, metrics_out=out,
                                      verbose=False, device="cpu")
    assert summary["requests"] == 10 and summary["replicas"] == 2
    assert sum(summary["statuses"].values()) == 10  # exactly-once, none lost
    assert summary["migrated"]                      # crash forced migration
    assert summary["migrated_finished"]
    assert summary["router"]["live_replicas"] == 1  # the victim stayed dead
    assert summary["abandoned_pool_bytes"] > 0
    assert summary["faults"]["r0"]["crashes"] == 1


def test_fleet_chaos_needs_two_replicas():
    with pytest.raises(ValueError, match="2 replicas"):
        tfaults.run_fleet_chaos(replicas=1, device="cpu")


def test_main_exit_code(capsys):
    assert tfaults.main(["--seed", "2", "--requests", "6",
                         "--device", "cpu"]) == 0
    assert "[chaos] seed=2" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    """No device given means the CUDA card: without one the suites and the
    demo raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import theory
    for fn in (lambda: tfaults.run_chaos(requests=2, verbose=False),
               lambda: tfaults.run_fleet_chaos(requests=2, verbose=False),
               lambda: tfaults.main(["--requests", "2"]),
               lambda: theory.universal_approx_demo(np.sin, steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
