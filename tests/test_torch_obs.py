"""The port's telemetry plane (``repro_torch/obs``) against ``repro``'s on
the same seeded inputs, and its wiring into both engines, the Trainer and
both launchers (CPU, smoke configs).

* Metrics: the same operations give the same snapshot, ``delta``,
  percentiles and Prometheus text.
* Emitter: the port's JSONL (a real serve run) passes
  ``repro.obs.emit.validate_jsonl`` with ``--min-traces``, and ``repro``'s
  lines pass the port's validator; ``--to-prom`` prints the same text.
* SLO watchdog: the same rules on the same snapshot sequence give the same
  alerts, and the CLI the same exit codes.
* Chrome trace: the port's trace passes ``repro.obs.chrometrace.
  validate_trace``.
* Engines: ``stats()`` holds every key of ``repro``'s (the port adds the
  documented ``PORT_KEYS``); obs off gives the tokens obs on gives, on
  every pool lane; the launchers' new flags and ``Trainer(obs=)`` run end
  to end.
"""
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax  # noqa: E402

    from repro.configs.registry import get_smoke_config  # noqa: E402
    from repro.models.registry import build_model  # noqa: E402
    from repro.obs import Obs as JObs  # noqa: E402
    from repro.obs import chrometrace as jchrome  # noqa: E402
    from repro.obs import emit as jemit  # noqa: E402
    from repro.obs import slo as jslo  # noqa: E402
    from repro.obs.metrics import Registry as JRegistry  # noqa: E402
    from repro.obs.metrics import prometheus_text as jprom  # noqa: E402
    from repro.quant.codec import QuantPolicy as JPolicy  # noqa: E402
    from repro.serve import engine as jeng  # noqa: E402
except ImportError:
    jax = None

from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.registry import init_params  # noqa: E402
from repro_torch.obs import Obs, chrometrace, emit, slo  # noqa: E402
from repro_torch.obs.metrics import (RATIO_BUCKETS, Histogram,  # noqa: E402
                                     Registry, prometheus_text)
from repro_torch.quant.codec import QuantPolicy  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      Request)

ARCH = "tinyllama-1.1b"
# stats() keys the port adds to repro's schema, by engine
PORT_KEYS = {
    "batch": {"prefills", "decode_steps", "cache_bytes", "dispatch_kinds",
              "quant_policy", "cache_dtype", "prefill_lanes", "device"},
    "continuous": {"decode_steps", "prefills", "decode_graphs",
                   "decode_capture_s", "device"},
}


def _need_ref():
    if jax is None:
        pytest.skip("needs jax and repro (the reference)")


def _reqs(vocab, n=4, new=5, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(1, vocab, 5 + 3 * i).astype(np.int32),
                    max_new_tokens=new, id=i) for i in range(n)]


def _cont(cfg, params, **kw):
    kw = dict(max_slots=2, max_seq=64, page_size=4, decode_chunk=4,
              device="cpu", **kw)
    return ContinuousEngine(cfg, params, **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One continuous serve on the CPU with every telemetry sink: JSONL,
    SLO watchdog, shadow oracle; its obs, file and stats."""
    d = tmp_path_factory.mktemp("obs")
    path = str(d / "m.jsonl")
    cfg = tget(ARCH)
    wd = slo.SloWatchdog()
    obs = Obs(emit_path=path, emit_every=2, slo=wd)
    eng = _cont(cfg, init_params(cfg, device="cpu"), obs=obs,
                quant=QuantPolicy("int8", quant_weights=True),
                shadow_sample=1.0)
    results = eng.generate(_reqs(cfg.vocab_size))
    st = eng.stats()
    eng.drain()                                # closes the emitter
    return {"obs": obs, "path": path, "stats": st, "results": results,
            "dir": d}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _drive(reg):
    reg.counter("tokens").inc(5)
    reg.counter("sched.deferred", reason="pages").inc(2)
    reg.gauge("pool.free_pages").set(7)
    reg.gauge("pool.free_pages").set(3)
    reg.gauge("never.set")
    h = reg.histogram("trace.ttft_s")
    for v in (0.003, 0.5, 1e-5, 70.0, 0.02):
        h.observe(v)
    reg.histogram("sched.slot_occupancy", bounds=RATIO_BUCKETS).observe_many(
        np.array([0.1, 0.5, 0.5, 1.0]))
    # a wide bulk fold: bucket edges and the overflow bucket
    vals = np.random.RandomState(2).lognormal(-3, 3, size=500)
    vals[:3] = [0.25, 2.5, 1e9]
    reg.histogram("quant.k_scale").observe_many(vals)
    reg.scoped(replica="r1").counter("tokens").inc(3)
    reg.scoped(replica="r1").scoped(zone="a").gauge("q").set(1.5)


def test_registry_matches_repro():
    _need_ref()
    treg, jreg = Registry(), JRegistry()
    _drive(treg)
    _drive(jreg)
    a, b = treg.snapshot(), jreg.snapshot()
    assert a == b
    assert prometheus_text(a) == jprom(b)
    assert treg.to_prometheus() == jreg.to_prometheus()
    old = {"counters": {"tokens": 1.0}}
    assert Registry.delta(a, old) == JRegistry.delta(b, old)
    # the bulk fold leaves the state a loop of observe() leaves (the sum
    # in numpy's order)
    loop = Histogram()
    for v in np.random.RandomState(2).lognormal(-3, 3, size=500):
        loop.observe(v)
    bulk = Histogram()
    bulk.observe_many(np.random.RandomState(2).lognormal(-3, 3, size=500))
    got, want = bulk.to_dict(), loop.to_dict()
    assert got.pop("sum") == pytest.approx(want.pop("sum"), rel=1e-12)
    assert got == want
    h = Histogram.of([3.0, 1.0, 2.0, 10.0])
    assert h.percentile(50) == float(np.percentile([3, 1, 2, 10], 50))
    with pytest.raises(TypeError):
        treg.gauge("tokens")


# ---------------------------------------------------------------------------
# emitter
# ---------------------------------------------------------------------------
def test_port_jsonl_passes_repro_validator(served):
    _need_ref()
    counts = jemit.validate_jsonl(served["path"])
    assert counts["trace"] == 4 and counts["snapshot"] >= 2
    assert counts == emit.validate_jsonl(served["path"])
    for v in (jemit.main, emit.main):
        with redirect_stdout(io.StringIO()):
            assert v(["--validate", served["path"], "--min-traces",
                      "4"]) == 0
            assert v(["--validate", served["path"], "--min-traces",
                      "5"]) == 1
    # --to-prom renders the last snapshot the same way
    outs = []
    for v in (jemit.main, emit.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert v(["--to-prom", served["path"]]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "tokens_total" in outs[0]


def test_repro_lines_pass_port_validator(tmp_path):
    _need_ref()
    path = str(tmp_path / "j.jsonl")
    wd = jslo.SloWatchdog([jslo.Rule("anom", metric="engine.anomalies",
                                     kind="rate", op=">", threshold=0.0,
                                     windows=((1, 1.0),))])
    obs = JObs(emit_path=path, emit_every=1, slo=wd)
    c = obs.registry.counter("engine.anomalies")
    obs.baseline()
    for i in range(3):
        tr = obs.trace_start(i, i, 5, obs.now())
        tr.mark_admit(obs.now())
        tr.mark_first_token(obs.now())
        tr.mark_chunk(obs.now(), 2)
        tr.status = "FINISHED_BUDGET"
        tr.mark_retire(obs.now())
        obs.trace_finish(tr)
        c.inc()
        obs.tick()
    obs.close()
    counts = emit.validate_jsonl(path)
    assert counts == jemit.validate_jsonl(path)
    assert counts["trace"] == 3 and counts["alert"] >= 1
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    no_counters = {k: v for k, v in lines[0].items() if k != "counters"}
    for bad in (no_counters, {**lines[-1], "type": "nope"},
                {**lines[1], "gauges": {"g": "high"}}):
        with pytest.raises(ValueError):
            emit.validate_line(bad)
        with pytest.raises(ValueError):
            jemit.validate_line(bad)


# ---------------------------------------------------------------------------
# SLO watchdog
# ---------------------------------------------------------------------------
def _snapshots(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f
                if ln.strip() and json.loads(ln)["type"] == "snapshot"]


def _sequence(path):
    """The serve run's snapshots, then a burn: anomalies rising, drift and
    TTFT high, agreement low, the clip ratio at the rail."""
    seq = _snapshots(path)
    last = json.loads(json.dumps(seq[-1]))
    for i in range(6):
        s = json.loads(json.dumps(last))
        s["seq"] = last["seq"] + 1 + i
        s["t_s"] = last["t_s"] + 1.0 + i
        s["counters"]["engine.anomalies"] = float(i + 1)
        s["counters"]["tokens"] = last["counters"]["tokens"] + 10 * i
        s["counters"]["quant.clip.kv_clipped"] = (
            last["counters"]["quant.clip.kv_clipped"] + 90 * (i + 1))
        s["counters"]["quant.clip.kv_total"] = (
            last["counters"]["quant.clip.kv_total"] + 100 * (i + 1))
        s["gauges"]["health.logit_drift"] = 100.0
        s["gauges"]["health.greedy_agreement"] = 0.1
        s["histograms"]["trace.ttft_s"]["p99"] = 50.0
        seq.append(s)
    return seq


def _rules(mod):
    return [mod.Rule("drift", metric="health.logit_drift*", kind="gauge",
                     op=">", threshold=10.0, windows=((2, 1.0), (4, 0.5))),
            mod.Rule("ttft", metric="trace.ttft_s", kind="histogram",
                     op=">=", threshold=5.0, windows=((1, 1.0),),
                     severity="warn"),
            mod.Rule("clip", metric="quant.clip.kv_clipped*", kind="ratio",
                     denom="quant.clip.kv_total", op=">", threshold=0.5,
                     windows=((2, 1.0),)),
            mod.Rule("anom", metric="engine.anomalies*", kind="rate",
                     op=">", threshold=0.0, windows=((1, 1.0),))]


def test_default_rules_match_repro():
    _need_ref()
    assert ([r.__dict__ for r in slo.default_rules()]
            == [r.__dict__ for r in jslo.default_rules()])


@pytest.mark.parametrize("rules", ["stock", "custom"])
def test_slo_alerts_match_repro(served, rules):
    _need_ref()
    seq = _sequence(served["path"])
    treg, jreg = Registry(), JRegistry()
    tw = slo.SloWatchdog(None if rules == "stock" else _rules(slo),
                         registry=treg)
    jw = jslo.SloWatchdog(None if rules == "stock" else _rules(jslo),
                          registry=jreg)
    for snap in seq:
        assert tw.observe(snap) == jw.observe(snap)
    assert tw.alerts == jw.alerts and tw.alerts
    assert tw.stats() == jw.stats()
    assert treg.snapshot() == jreg.snapshot()
    for a in tw.alerts:
        emit.validate_line(a)


def test_slo_cli_exit_codes_match_repro(served, tmp_path):
    _need_ref()
    path = str(tmp_path / "burn.jsonl")
    with open(path, "w") as f:
        for snap in _sequence(served["path"]):
            f.write(json.dumps(snap) + "\n")
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write("{not json\n")
    for args in ([served["path"]], [path], [path, "--fail-on", "warn"],
                 [bad]):
        codes = []
        for mod in (slo, jslo):
            with redirect_stdout(io.StringIO()):
                codes.append(mod.main(args))
        assert codes[0] == codes[1], args
    with redirect_stdout(io.StringIO()):
        assert slo.main([path]) == 1 and slo.main([bad]) == 2


# ---------------------------------------------------------------------------
# Chrome trace
# ---------------------------------------------------------------------------
def test_chrome_trace_passes_repro_validator(served):
    _need_ref()
    path = os.path.join(str(served["dir"]), "t.json")
    trace = chrometrace.write_trace(served["obs"], path,
                                    extra_meta={"arch": ARCH})
    jchrome.validate_trace(trace)
    chrometrace.validate_trace(trace)
    cats = {ev.get("cat") for ev in trace["traceEvents"]}
    assert {"request", "dispatch"} <= cats
    lanes = {ev["args"]["name"] for ev in trace["traceEvents"]
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    assert "decode_chunk" in lanes
    with redirect_stdout(io.StringIO()):
        assert jchrome.main(["--validate", path, "--min-requests", "4"]) == 0
        assert chrometrace.main(["--validate", path,
                                 "--min-requests", "4"]) == 0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def test_served_stats_carry_the_planes(served):
    st = served["stats"]
    assert st["hardware"] == "host-cpu"
    assert {k.split("_")[0] for k in st["roofline"]} >= {"prefill",
                                                         "decode"}
    for kind, r in st["roofline"].items():
        assert r["dispatches"] > 0 and 0 < r["roofline_frac"], kind
        assert r["flops"] > 0 and r["bytes_accessed"] > 0, kind
    assert st["shadow_oracle"]["replays"] == 4
    assert st["health"]["nonfinite_dispatches"] == 0
    assert 0 < st["kv_clip_rate"] < 1
    snap = served["obs"].registry.snapshot()
    assert snap["gauges"]["quant.plane_clip_rate"] > 0
    assert snap["histograms"]["trace.ttft_s"]["count"] == 4
    assert all(r["status"] == "FINISHED_BUDGET" for r in served["results"])
    assert served["obs"].summary().startswith("metric")


@pytest.fixture(scope="module")
def repro_stats():
    """``repro``'s engines on its smoke tinyllama: their stats() keys."""
    _need_ref()
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    reqs = [jeng.Request(prompt=r.prompt, max_new_tokens=3, id=r.id)
            for r in _reqs(cfg.vocab_size, n=2)]
    cont = jeng.ContinuousEngine(cfg, params, max_slots=2, max_seq=64,
                                 page_size=4, decode_chunk=4,
                                 quant=JPolicy("int8", quant_weights=True),
                                 shadow_sample=1.0)
    cont.generate(reqs)
    batch = jeng.Engine(cfg, params, max_batch=2, max_seq=64)
    batch.generate(reqs)
    return {"continuous": set(cont.stats()), "batch": set(batch.stats())}


def test_stats_keys_match_repro(repro_stats, served):
    cfg = tget(ARCH)
    eng = Engine(cfg, init_params(cfg, device="cpu"), max_batch=2,
                 max_seq=64, device="cpu")
    eng.generate(_reqs(cfg.vocab_size, n=2, new=3))
    got = {"continuous": set(served["stats"]), "batch": set(eng.stats())}
    for name in ("continuous", "batch"):
        assert got[name] - repro_stats[name] == PORT_KEYS[name], name
        assert repro_stats[name] <= got[name], name


@pytest.mark.parametrize("kv_dtype,impl,bits", [
    ("f32", "stream", 0), ("bf16", "stream", 0), ("int8", "stream", 8),
    ("f32", "gather", 4), ("int8", "stream", 0)])
def test_obs_off_gives_the_same_tokens(kv_dtype, impl, bits):
    cfg = tget(ARCH)
    policy = QuantPolicy(kv_dtype, quant_weights=bool(bits),
                         weight_bits=bits or 8)
    toks = []
    for obs in (Obs(enabled=False), Obs(), None):
        kw = {} if obs is None else {"obs": obs}
        eng = _cont(cfg, init_params(cfg, device="cpu"), quant=policy,
                    paged_attn=impl, capture=None if obs else False, **kw)
        toks.append([r["tokens"] for r in eng.generate(
            _reqs(cfg.vocab_size, n=3, new=9))])
        assert eng.stats()["statuses"]["FINISHED_BUDGET"] == 3
    assert toks[0] == toks[1] == toks[2]


def test_batch_engine_obs_off_and_traces():
    cfg = tget(ARCH)
    params = init_params(cfg, device="cpu")
    out = {}
    for enabled in (False, True):
        obs = Obs(enabled=enabled)
        eng = Engine(cfg, params, max_batch=2, max_seq=64, device="cpu",
                     obs=obs)
        out[enabled] = [r["tokens"] for r in eng.generate(
            _reqs(cfg.vocab_size, n=3, new=4))]
        st = eng.stats()
        if enabled:
            assert len(obs.traces.completed) == 3
            kinds = set(st["roofline"])
            assert any(k.startswith("prefill_b") for k in kinds)
            assert any(k.startswith("decode_loop_s") for k in kinds)
        else:
            assert not obs.traces.completed
            assert all(r["dispatches"] == 0
                       for r in st["roofline"].values())
    assert out[False] == out[True]


def test_continuous_engine_lifecycle_hooks():
    cfg = tget(ARCH)
    params = init_params(cfg, device="cpu")
    from repro_torch.serve.faults import FaultConfig, FaultInjector
    faults = FaultInjector(FaultConfig(seed=0))
    eng = _cont(cfg, params, faults=faults)
    assert eng.faults is faults
    assert eng.block_table.allocator.fault == faults.alloc_fault
    eng = _cont(cfg, params)
    assert eng.anomalies == 0
    eng.reset_serve_clock()
    eng.submit(_reqs(cfg.vocab_size, n=1)[0])
    with pytest.raises(RuntimeError, match="in flight"):
        eng.reset_serve_clock()
    eng.drain()
    eng.reset_serve_clock()
    assert eng._t0_perf is None


def test_scoped_obs_labels_one_engine(tmp_path):
    cfg = tget(ARCH)
    base = Obs(emit_path=str(tmp_path / "f.jsonl"), emit_every=1)
    eng = _cont(cfg, init_params(cfg, device="cpu"),
                obs=base.scoped(replica="r0"))
    eng.generate(_reqs(cfg.vocab_size, n=2))
    base.close()
    snap = base.registry.snapshot()
    assert snap["counters"]["tokens{replica=r0}"] == 10
    assert all(k.startswith("r0:") for k in base.profiler.costs)
    assert {t.replica for t in base.traces.completed} == {"r0"}
    assert emit.validate_jsonl(str(tmp_path / "f.jsonl"))["trace"] == 2


# ---------------------------------------------------------------------------
# Trainer and launchers
# ---------------------------------------------------------------------------
def test_trainer_obs_streams_jsonl(tmp_path):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.trainer import Trainer
    cfg = tget(ARCH)
    path = str(tmp_path / "train.jsonl")
    obs = Obs(emit_path=path, emit_every=1)
    tr = Trainer(cfg, workdir=str(tmp_path / "w"),
                 data_fn=SyntheticLM(cfg, batch=2, seq=16, seed=0),
                 total_steps=3, ckpt_every=0, log_every=10, obs=obs,
                 device="cpu")
    tr.run()
    obs.close()
    assert tr.registry is obs.registry
    snaps = _snapshots(path)
    assert len(snaps) == 4                     # a tick a step, then close
    assert [s["counters"]["train.steps"] for s in snaps] == [1, 2, 3, 3]
    assert all(np.isfinite(s["gauges"]["train.loss"]) for s in snaps)
    assert emit.validate_jsonl(path)["snapshot"] == 4
    if jax is not None:
        assert jemit.validate_jsonl(path)["snapshot"] == 4


def test_launch_train_metrics_out(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with redirect_stdout(io.StringIO()) as buf:
        out = ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "16",
                           "--workdir", str(tmp_path / "w"),
                           "--metrics-out", path, "--metrics-every", "1",
                           "--ckpt-every", "0"])
    assert "metrics: 3 lines" in buf.getvalue()
    assert emit.validate_jsonl(path) == {"snapshot": 3, "trace": 0,
                                         "alert": 0}
    assert out["obs"].registry.value("train.steps") == 2


@pytest.mark.parametrize("engine", ["continuous", "batch"])
def test_launch_serve_obs_flags(tmp_path, engine):
    m, t = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    rules = str(tmp_path / "rules.json")
    with open(rules, "w") as f:
        json.dump([{"name": "ttft", "metric": "trace.ttft_s",
                    "kind": "histogram", "op": ">", "threshold": 0.0,
                    "windows": [[1, 1.0]], "severity": "warn"}], f)
    with redirect_stdout(io.StringIO()) as buf:
        out = tserve.main(["--arch", ARCH, "--device", "cpu", "--engine",
                           engine, "--requests", "4", "--new-tokens", "4",
                           "--metrics-out", m, "--metrics-every", "2",
                           "--trace-out", t, "--slo", "--slo-rules", rules,
                           "--shadow-sample", "1.0", "--hardware", "h100"])
    text = buf.getvalue()
    for line in ("roofline (h100)", "metrics:", "slo:", "chrome trace:",
                 "obs summary:"):
        assert line in text, line
    if engine == "continuous":
        assert "pool pressure:" in text and "shadow oracle:" in text
        assert "health:" in text
    assert out["stats"]["hardware"] == "h100"
    assert emit.validate_jsonl(m)["trace"] == 4
    with open(t) as f:
        chrometrace.validate_trace(json.load(f))
    if jax is not None:
        assert jemit.validate_jsonl(m)["trace"] == 4
        assert out["obs"].slo.alerts           # a rule that always fires


def test_launch_serve_no_obs():
    with redirect_stdout(io.StringIO()) as buf:
        out = tserve.main(["--arch", ARCH, "--device", "cpu", "--engine",
                           "continuous", "--requests", "2",
                           "--new-tokens", "3", "--no-obs"])
    assert "obs summary" not in buf.getvalue()
    assert "health" not in out["stats"]
    assert not out["obs"].traces.completed
