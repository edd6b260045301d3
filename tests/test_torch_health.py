"""The numerics health plane of the port (``repro_torch/obs/health.py``,
``serve/decode.py``'s capture, ``quant/calibrate.py``'s parity harness)
against ``repro``'s on the same seeded inputs and weights (smoke
tinyllama, float32; weights carried by ``models/convert.py``).

Tolerances: ``logit_stats`` 1e-5 (NaN equal to NaN); the capture stats of
the prefill and of the paged loop 1e-4 (float32 sums in another order);
the ``anom`` mask and ``greedy_agreement`` exactly; ``max_logit_drift``
within 1e-4.  ``HealthPlane`` folds of the same arrays give the same
registry snapshot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax  # noqa: E402
    import jax.numpy as jnp  # noqa: E402

    from repro.configs.registry import get_smoke_config  # noqa: E402
    from repro.models.registry import build_model  # noqa: E402
    from repro.obs.health import HealthPlane as JHealthPlane  # noqa: E402
    from repro.obs.metrics import Registry as JRegistry  # noqa: E402
    from repro.quant import calibrate as jcal  # noqa: E402
    from repro.quant.codec import QuantPolicy as JPolicy  # noqa: E402
    from repro.serve import decode as jdec  # noqa: E402
    from repro.serve import kvcache as jkv  # noqa: E402
    from repro.serve.params import precompute_serving_params as jbake  # noqa: E402,E501
except ImportError:
    jax = None

from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs.health import HealthPlane, ShadowOracle  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, Request  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402,E501

ARCH = "tinyllama-1.1b"
PAGE, MAXP, CHUNK = 4, 6, 4
POS = np.array([9, 5, -1, 7], np.int32)
REM = np.array([10, 3, 0, 0], np.int32)
TABLE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12],
                  [0, 0, 0, 0, 0, 0], [13, 14, 15, 16, 17, 18]], np.int32)
NUM_PAGES = 19


def _need_ref():
    if jax is None:
        pytest.skip("needs jax and repro (the reference)")


@pytest.fixture(scope="module")
def raw():
    """``repro``'s raw float32 smoke tinyllama and its port (unbaked)."""
    _need_ref()
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    return cfg, tcfg, params, model


@pytest.fixture(scope="module")
def baked(raw):
    cfg, tcfg, params, model = raw
    return cfg, tcfg, jbake(params, cfg), tbake(
        tcal.fresh_serving_params(model, tcfg), tcfg)


# ---------------------------------------------------------------------------
# logit_stats
# ---------------------------------------------------------------------------
def _logit_rows():
    rng = np.random.RandomState(3)
    rows = rng.randn(9, 37).astype(np.float32) * 3
    rows[1, 5] = np.nan                       # NaN
    rows[2, 7] = np.inf                       # +inf
    rows[3, 0] = -np.inf                      # -inf, finite max
    rows[4, [2, 9]] = rows[4].max() + 1.0     # tied maxima
    rows[5] = 0.0                             # all equal
    rows[6, [1, 2]] = np.inf                  # two +inf
    rows[7, :] = -np.inf                      # all -inf
    return rows


def test_logit_stats_matches_repro():
    _need_ref()
    rows = _logit_rows()
    want = np.asarray(jdec.logit_stats(jnp.asarray(rows)))
    got = tdec.logit_stats(torch.from_numpy(rows)).numpy()
    assert got.shape == want.shape == (9, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    assert got[4, 2] == 0.0                   # a tie has no margin
    # batched leading axes and a bf16 row reduce the same way
    got3 = tdec.logit_stats(torch.from_numpy(rows.reshape(3, 3, 37)))
    np.testing.assert_array_equal(got3.reshape(9, 4).numpy(), got)


# ---------------------------------------------------------------------------
# HealthPlane folds
# ---------------------------------------------------------------------------
def _snapshots_equal(a, b):
    assert a.keys() == b.keys()
    for section in a:
        assert a[section].keys() == b[section].keys(), section
        for name in a[section]:
            va, vb = a[section][name], b[section][name]
            if isinstance(va, dict):
                assert va.keys() == vb.keys()
                for k in va:
                    x, y = va[k], vb[k]
                    if isinstance(x, float) and isinstance(y, float):
                        assert x == pytest.approx(y, rel=1e-12), (name, k)
                    else:
                        assert x == y, (name, k)
            else:
                assert va == pytest.approx(vb, rel=1e-12), name


def test_health_plane_folds_match_repro():
    _need_ref()
    rng = np.random.RandomState(7)
    treg, jreg = Registry(), JRegistry()
    tplane, jplane = HealthPlane(treg), JHealthPlane(jreg)
    for i in range(5):
        logit = np.array([rng.uniform(0.1, 50), rng.uniform(0, 10),
                          rng.uniform(0, 5), 0.0])
        if i == 3:                            # a poisoned prefill
            logit = np.array([np.nan, np.nan, np.nan, 7.0])
        act = rng.uniform(0.01, 300, size=8)
        act[2] = np.inf if i == 1 else act[2]
        for plane in (tplane, jplane):
            plane.on_prefill({"logit": logit.copy(), "act_absmax": act.copy()})
        stats = np.abs(rng.randn(4, 4)) * 10
        stats[:, 3] = 0.0
        stats[1, 3] = 2.0                     # non-finite steps
        stats[2, :3] = np.nan
        steps = np.array([3, 1, 0, 2 if i % 2 else 0])
        for plane in (tplane, jplane):
            plane.on_decode(stats.copy(), steps=steps)
    _snapshots_equal(treg.snapshot(), jreg.snapshot())
    assert tplane.stats() == jplane.stats()
    assert tplane.nonfinite_dispatches == jplane.nonfinite_dispatches == 6


# ---------------------------------------------------------------------------
# the prefill's capture vector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefill_capture_matches_repro(baked, kv_dtype):
    cfg, tcfg, params, model = baked
    S, n_pages = 10, 3
    prompt = np.random.RandomState(1).randint(1, cfg.vocab_size, S)
    padded = np.zeros(n_pages * PAGE, np.int32)
    padded[:S] = prompt
    pages = np.array([2, 5, 3], np.int32)
    jpool = jkv.build_pool(cfg, 8, PAGE, JPolicy(kv_dtype))
    jfn = jdec.make_prefill_pack_step(cfg, n_pages, PAGE, capture_stats=True)
    jtok, jok, _, jstats = jfn(params, {"tokens": jnp.asarray(padded[None])},
                               jpool, jnp.asarray(pages), jnp.int32(S))
    tpool = tkv.build_pool(tcfg, 8, PAGE, tq.QuantPolicy(kv_dtype),
                           device="cpu")
    tfn = tdec.make_prefill_pack_step(tcfg, n_pages, PAGE,
                                      capture_stats=True)
    with torch.no_grad():
        ttok, tok_, _, tstats = tfn(
            model, {"tokens": torch.from_numpy(padded[None].astype(np.int64))},
            tpool, torch.from_numpy(pages).long(), S)
    assert int(ttok) == int(jtok) and bool(tok_) == bool(jok)
    want, got = np.asarray(jstats), tstats.numpy()
    assert got.shape == want.shape == (6 + 2 * tcfg.num_layers,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if kv_dtype == "int8":
        assert 0 < got[4] < got[5]            # the clip census ran
    else:
        assert got[4] == got[5] == 0.0
    # without capture the step returns no stats
    plain = tdec.make_prefill_pack_step(tcfg, n_pages, PAGE)
    with torch.no_grad():
        assert plain(model, {"tokens": torch.from_numpy(
            padded[None].astype(np.int64))}, tpool,
            torch.from_numpy(pages).long(), S)[3] is None


# ---------------------------------------------------------------------------
# the paged loop's capture stats
# ---------------------------------------------------------------------------
def _pool_values(tcfg, kv_dtype, seed=0):
    rng = np.random.RandomState(seed)
    shapes = tkv.build_pool(tcfg, NUM_PAGES, PAGE, tq.QuantPolicy(kv_dtype),
                            device="cpu")
    vals = {}
    for key, t in shapes.items():
        if key.endswith("_scale"):
            vals[key] = rng.uniform(0.01, 0.03, t.shape).astype(np.float32)
        elif t.dtype == torch.int8:
            vals[key] = rng.randint(-127, 128, t.shape).astype(np.int8)
        else:
            vals[key] = rng.randn(*t.shape).astype(np.float32)
    return vals


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_paged_loop_capture_matches_repro(baked, kv_dtype):
    """Two dispatches of a chunk of 4 with slot 1's first page poisoned
    (NaN keys): stats (B, 4) within 1e-4, ``anom`` identical."""
    cfg, tcfg, params, model = baked
    vals = _pool_values(tcfg, kv_dtype)
    jpool = [({k: jnp.asarray(v) for k, v in vals.items()},)]
    tpool = tkv.build_pool(tcfg, NUM_PAGES, PAGE, tq.QuantPolicy(kv_dtype),
                           device="cpu")
    for k, v in vals.items():
        tpool[k].copy_(torch.from_numpy(v))
    # poison slot 1: its page 7 holds NaN keys (an int8 pool: NaN scales)
    key = "k_scale" if kv_dtype == "int8" else "k"
    jpool[0][0][key] = jpool[0][0][key].at[:, 7].set(jnp.nan)
    tpool[key][:, 7] = float("nan")
    cur = np.random.RandomState(1).randint(1, 500, 4).astype(np.int32)
    jloop = jax.jit(jdec.make_paged_decode_loop(cfg, CHUNK,
                                                capture_stats=True))
    tloop = tdec.make_paged_decode_loop(tcfg, CHUNK, capture_stats=True,
                                        graphs=False)
    js = (jnp.asarray(cur), jnp.asarray(POS), jnp.asarray(REM))
    ts = tuple(torch.from_numpy(a) for a in (cur, POS, REM))
    for _ in range(2):
        jbuf, jc, jpool, jp, jr, _, janom, jstats = jloop(
            params, js[0], jpool, jnp.asarray(TABLE), js[1], js[2])
        with torch.no_grad():
            tbuf, tc, tpool, tp, tr, _, tanom, _ = tloop(
                model, ts[0], tpool, torch.from_numpy(TABLE), ts[1], ts[2])
        np.testing.assert_array_equal(tanom.numpy(), np.asarray(janom))
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
        got, want = tloop.last_stats.numpy(), np.asarray(jstats)
        assert got.shape == want.shape == (4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        js, ts = (jc, jp, jr), (tc, tp, tr)
    assert np.asarray(janom)[1] and got[1, 3] >= 1    # the poisoned slot
    assert got[0, 3] == 0 and got[0, 0] > 0


def test_paged_loop_without_capture_has_no_stats(baked):
    _, tcfg, _, model = baked
    pool = tkv.build_pool(tcfg, NUM_PAGES, PAGE, tq.QuantPolicy(),
                          device="cpu")
    loop = tdec.make_paged_decode_loop(tcfg, CHUNK, graphs=False)
    with torch.no_grad():
        loop(model, torch.from_numpy(REM), pool, torch.from_numpy(TABLE),
             torch.from_numpy(POS), torch.from_numpy(REM))
    assert loop.last_stats is None
    assert loop.slots(model, pool, 4, MAXP).lastrow is None


# ---------------------------------------------------------------------------
# parity harness (quant/calibrate.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype,bits", [("f32", 8), ("int8", 8),
                                           ("int8", 4)])
def test_parity_report_matches_repro(raw, kv_dtype, bits):
    cfg, tcfg, params, model = raw
    want = jcal.parity_report(cfg, params, policy=JPolicy(
        kv_dtype, quant_weights=True, weight_bits=bits), new_tokens=8)
    policy = tq.QuantPolicy(kv_dtype, quant_weights=True, weight_bits=bits)
    got = tcal.parity_report(tcfg, model, policy=policy, new_tokens=8)
    assert got["steps"] == want["steps"] == 8
    assert got["greedy_agreement"] == want["greedy_agreement"]
    assert abs(got["max_logit_drift"] - want["max_logit_drift"]) <= 1e-4
    assert got["max_logit_drift"] > 0          # quantization moved logits
    assert got["policy"] == policy.describe()
    # the caller's module keeps no planes of either side
    assert next(iter(tq.baked_caches(model)), None) is None


def test_servable_parity_sweep_runs_on_cpu():
    got = tcal.servable_parity_sweep(tq.QuantPolicy("int8",
                                                    quant_weights=True),
                                     archs=["tinyllama-1.1b"], new_tokens=4,
                                     device="cpu")
    assert [r["arch"] for r in got] == ["tinyllama-1.1b"]
    assert 0.0 <= got[0]["greedy_agreement"] <= 1.0


# ---------------------------------------------------------------------------
# the shadow oracle and the engine's health plane
# ---------------------------------------------------------------------------
def _engine(model, tcfg, **kw):
    kw = dict(max_slots=2, max_seq=48, page_size=PAGE, decode_chunk=4,
              device="cpu", **kw)
    return ContinuousEngine(tcfg, tcal.fresh_serving_params(model, tcfg),
                            **kw)


def _reqs(tcfg, n=3, new=5):
    rng = np.random.RandomState(5)
    return [Request(prompt=rng.randint(1, tcfg.vocab_size, 6 + 3 * i)
                    .astype(np.int32), max_new_tokens=new, id=i)
            for i in range(n)]


def test_shadow_oracle_gauges_are_lazy_and_queue_bounded(raw):
    _, tcfg, _, model = raw
    reg = Registry()
    sh = ShadowOracle(tcfg, model, policy=tq.QuantPolicy(), registry=reg,
                      sample=1.0, max_pending=2)
    snap = reg.snapshot()
    assert "health.greedy_agreement" not in snap["gauges"]
    for i in range(3):
        sh.maybe_enqueue(np.arange(1, 6), 3)
    assert sh.pending == 2 and sh.stats()["dropped"] == 1
    never = ShadowOracle(tcfg, model, policy=tq.QuantPolicy(),
                         registry=Registry(), sample=0.0)
    assert not never.maybe_enqueue(np.arange(1, 6), 3)


def test_online_agreement_matches_the_harness(raw):
    """The engine's shadow replays are ``ParityRunner`` runs of the
    finished requests: the steps-weighted agreement and the max drift
    equal those of the same runs made by hand."""
    _, tcfg, _, model = raw
    policy = tq.QuantPolicy("int8", quant_weights=True)
    eng = _engine(model, tcfg, quant=policy, shadow_sample=1.0, seed=0)
    reqs = _reqs(tcfg)
    eng.generate(reqs)
    sh = eng.stats()["shadow_oracle"]
    assert sh["replays"] == sh["sampled"] == len(reqs)
    runner = tcal.ParityRunner(
        tcfg, tcal.fresh_serving_params(model, tcfg),
        tcal.fresh_serving_params(model, tcfg, policy), policy=policy,
        page_size=PAGE)
    runs = [runner.run(r.prompt, r.max_new_tokens) for r in reqs]
    steps = sum(r["steps"] for r in runs)
    agree = sum(r["greedy_agreement"] * r["steps"] for r in runs) / steps
    assert sh["steps"] == steps
    assert sh["greedy_agreement"] == pytest.approx(agree, rel=1e-12)
    assert sh["logit_drift"] == max(r["max_logit_drift"] for r in runs)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_capture_fills_the_health_plane(raw, kv_dtype):
    _, tcfg, _, model = raw
    eng = _engine(model, tcfg, quant=tq.QuantPolicy(kv_dtype))
    eng.generate(_reqs(tcfg))
    st = eng.stats()
    snap = eng.obs.registry.snapshot()
    hist = snap["histograms"]
    for name in ("health.logit_absmax{phase=prefill}",
                 "health.logit_absmax{phase=decode}",
                 "health.logit_entropy{phase=decode}",
                 "health.act_absmax{phase=prefill}"):
        assert hist[name]["count"] > 0, name
        assert np.isfinite(hist[name]["sum"]), name
    assert st["health"]["nonfinite_dispatches"] == 0
    if kv_dtype == "int8":
        assert 0.0 < st["kv_clip_rate"] < 1.0
        assert hist["quant.k_scale"]["count"] > 0
        assert st["scale_growths"] >= 0
    else:
        assert st["kv_clip_rate"] is None


def test_disabled_obs_and_capture_false_skip_the_capture(raw):
    _, tcfg, _, model = raw
    for kw in (dict(obs=Obs(enabled=False)), dict(capture=False)):
        eng = _engine(model, tcfg, **kw)
        eng.generate(_reqs(tcfg, n=1))
        st = eng.stats()
        assert "health" not in st
        assert eng._loop.last_stats is None
    eng = _engine(model, tcfg, capture=False)
    eng.generate(_reqs(tcfg, n=1))
    assert eng.stats()["roofline"]          # spans stay on


def test_shadow_sample_needs_precompute(raw):
    _, tcfg, _, model = raw
    with pytest.raises(ValueError, match="precompute"):
        _engine(model, tcfg, shadow_sample=0.5, precompute=False)
