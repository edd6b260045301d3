"""The port's fixed-point serving stack against ``repro``'s: the codec, the
int8 page scatter and prefill packing, the quantized-plane spectral linear,
the carry-over of quantized planes, the calibration report, and the
continuous engine under ``quant=QuantPolicy(...)`` (smoke tinyllama,
float32 activations).

Inputs are made with numpy from a seed and fed to both packages.  The codec,
``page_scatter`` and ``pack_prefill_cache`` are held EXACTLY: the same
float32 inputs give the same int8 codes and scales (``torch.round`` and
``jnp.round`` both round half to even).  The quantized linear is held to
1e-5 of its output scale: both sides contract the same integer planes in
float32, in another order.

Engine runs give both packages identical int8 / int4 planes (``repro``'s,
carried by ``from_jax_params``).  The int8 pool is quantized on each side
from K/V values that differ by float32 rounding (~1e-6), so a value that
sits on a rounding boundary could get another code; the greedy tokens of
these runs are identical all the same, and a test that found otherwise
would have to fall back to logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import calibrate as jcal  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import bc_fused as tbf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import calibrate as tcal  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402

ARCH = "tinyllama-1.1b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# codec, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_scalar_codec_equal(qmax):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 6) * np.exp(rng.randn(4, 1, 1))).astype(np.float32)
    x[1] = 0.0                                     # an all-zero block
    for axes in ((0, 2), -1, (-2, -1)):
        _eq(tq.absmax_scale(_t(x), axes, qmax),
            jq.absmax_scale(jnp.asarray(x), axes, qmax))
    s = np.asarray(jq.absmax_scale(jnp.asarray(x), (-2, -1), qmax))[:, None,
                                                                     None]
    q = tq.quantize(_t(x), _t(s), qmax)
    _eq(q, jq.quantize(jnp.asarray(x), jnp.asarray(s), qmax))
    _eq(tq.dequantize(q, _t(s)), jq.dequantize(jnp.asarray(q.numpy()),
                                               jnp.asarray(s)))
    clipped, total = tq.saturation_counts(q, qmax)
    jc, jt = jq.saturation_counts(jnp.asarray(q.numpy()), qmax)
    assert float(clipped) == float(jc) and total == jt


def test_round_half_to_even_on_ties():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, -127.5],
                 np.float32)
    got = tq.quantize(_t(x), torch.ones(()))
    _eq(got, jq.quantize(jnp.asarray(x), jnp.ones(())))
    assert got.tolist() == [0, 2, 2, 0, -2, 4, 126, -127]


@pytest.mark.parametrize("n", [6, 65])
def test_int4_pack_unpack_equal(n):
    rng = np.random.RandomState(n)
    q = rng.randint(-7, 8, size=(3, 4, n)).astype(np.int8)
    packed = tq.pack_int4(_t(q))
    _eq(packed, jq.pack_int4(jnp.asarray(q)))
    _eq(tq.unpack_int4(packed, n), q)
    _eq(tq.unpack_int4(packed, n), jq.unpack_int4(jnp.asarray(
        packed.numpy()), n))


@pytest.mark.parametrize("bits", [8, 4])
def test_plane_quantization_equal(bits):
    rng = np.random.RandomState(bits)
    cache = {n: (rng.randn(2, 3, 5, 65) * (1 + i)).astype(np.float32)
             for i, n in enumerate(tq.PLANE_NAMES)}
    mine = tq.quantize_plane_cache({n: _t(w) for n, w in cache.items()},
                                   bits)
    theirs = jq.quantize_plane_cache({n: jnp.asarray(w)
                                      for n, w in cache.items()}, bits)
    assert set(mine) == set(theirs)
    for key in theirs:
        _eq(mine[key], theirs[key])
    assert tq.quantize_plane_cache(mine, bits) == mine          # idempotent
    for name in tq.PLANE_NAMES:
        w, s = tq.plane_from_cache(mine, name, 65)
        jw, js = jq.plane_from_cache(theirs, name, 65)
        _eq(w, jw)
        _eq(s, js)


def test_page_block_quantization_equal():
    rng = np.random.RandomState(1)
    vals = (rng.randn(2, 3, 4, 2, 8) * 3).astype(np.float32)
    q, s = tq.quantize_page_block(_t(vals))
    jq_, js = jq.quantize_page_block(jnp.asarray(vals))
    _eq(q, jq_)
    _eq(s, js)


# ---------------------------------------------------------------------------
# page_scatter: grow and no-grow steps, exactly, and the identity that lets
# it run the requantize path unconditionally
# ---------------------------------------------------------------------------
def _scatter_case(grow):
    rng = np.random.RandomState(2 + grow)
    P, page, H, D = 6, 4, 2, 8
    q, s = jq.quantize_page_block(jnp.asarray(
        rng.randn(P, page, H, D).astype(np.float32)))
    pid = np.array([3, 1, 5], np.int32)
    off = np.array([0, 2, 3], np.int32)
    x = rng.randn(3, H, D).astype(np.float32)
    if grow:
        x[1, 0] *= 40.0                          # slot 1, head 0 outgrows
    else:
        x *= 0.1 * float(np.asarray(s).min()) / np.abs(x).max()
    return np.asarray(q), np.asarray(s), pid, off, x


@pytest.mark.parametrize("grow", [True, False])
def test_page_scatter_equal(grow):
    q, s, pid, off, x = _scatter_case(grow)
    jpool, jsc = jq.page_scatter(jnp.asarray(q), jnp.asarray(s),
                                 jnp.asarray(pid), jnp.asarray(off),
                                 jnp.asarray(x))
    pool, sc = _t(q), _t(s)
    got_pool, got_sc = tq.page_scatter(pool, sc, _t(pid).long(),
                                       _t(off).long(), _t(x))
    assert got_pool is pool and got_sc is sc                 # in place
    _eq(pool, jpool)
    _eq(sc, jsc)
    assert bool((sc > _t(s)).any()) == grow


def test_page_scatter_without_growth_is_the_single_row_write():
    q, s, pid, off, x = _scatter_case(False)
    pool, sc = _t(q), _t(s)
    tq.page_scatter(pool, sc, _t(pid).long(), _t(off).long(), _t(x))
    want = _t(q)
    want[_t(pid).long(), _t(off).long()] = tq.quantize(
        _t(x), _t(s)[_t(pid).long()][..., None])
    _eq(pool, want.numpy())
    _eq(sc, s)


# ---------------------------------------------------------------------------
# int8 pool: build, prefill packing with true_len, byte accounting
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cfgs():
    return (get_smoke_config(ARCH).replace(dtype="float32"),
            tget(ARCH).replace(dtype="float32"))


@pytest.mark.parametrize("true_len", [10, None])
def test_int8_pack_prefill_equal(cfgs, true_len):
    cfg, tcfg = cfgs
    rng = np.random.RandomState(3)
    page, P, spad = 4, 7, 12
    a = cfg.attention
    dense = {key: rng.randn(cfg.num_layers, 1, spad, a.num_kv_heads,
                            a.head_dim).astype(np.float32)
             for key in ("k", "v")}
    dense["k"][:, :, 10:] *= 50.0            # a loud pad tail
    pages = np.array([5, 2, 6], np.int32)
    jdense = ({"k": jnp.asarray(dense["k"]), "v": jnp.asarray(dense["v"]),
               "pos": jnp.zeros((cfg.num_layers, spad), jnp.int32)},)
    policy = jq.QuantPolicy("int8")
    ref, jclip, jtotal = jkv.pack_prefill_cache(
        jkv.build_pool(cfg, P, page, policy), [jdense], jnp.asarray(pages),
        page, true_len=true_len, with_stats=True)
    pool = tkv.build_pool(tcfg, P, page, tq.QuantPolicy("int8"),
                          device="cpu")
    got, clip, total = tkv.pack_prefill_cache(
        pool, {k: _t(v) for k, v in dense.items()}, _t(pages), page,
        true_len=true_len, with_stats=True)
    assert got is pool
    for key in ("k", "v", "k_scale", "v_scale"):
        _eq(got[key], ref[0][0][key])
    assert float(clip) == float(jclip) and float(total) == float(jtotal)
    assert tkv.pool_bytes(got) == jkv.pool_bytes(ref)


def test_pool_policies_and_byte_terms(cfgs):
    cfg, tcfg = cfgs
    for kv in ("f32", "bf16", "int8"):
        jp, tp = jq.QuantPolicy(kv), tq.QuantPolicy(kv)
        jpool = jkv.build_pool(cfg, 9, 4, jp)
        tpool = tkv.build_pool(tcfg, 9, 4, tp, device="cpu")
        assert sorted(tpool) == sorted(jpool[0][0])
        for key, leaf in jpool[0][0].items():
            assert tuple(tpool[key].shape) == leaf.shape
            assert tpool[key].element_size() == leaf.dtype.itemsize
        assert tkv.pool_bytes(tpool) == jkv.pool_bytes(jpool)
        assert tkv.page_bytes(tcfg, 4, tp) == jkv.page_bytes(cfg, 4, jp)
        assert (tkv.attention_bytes_per_position(tpool)
                == jkv.attention_bytes_per_position(jpool))
        for impl in ("stream", "gather"):
            assert (tkv.attention_memory_est(tpool, 2, 8, 4, impl)
                    == jkv.attention_memory_est(jpool, 2, 8, 4, impl))
        scales = tkv.pool_scale_map(tpool)
        assert (scales is None) == (kv != "int8")
    assert tp.describe() == jp.describe()
    assert tp.pool_dtype == torch.int8 and tp.kv_quantized
    with pytest.raises(ValueError):
        tq.QuantPolicy(kv_dtype="fp4")
    with pytest.raises(ValueError):
        tq.QuantPolicy(weight_bits=2)


# ---------------------------------------------------------------------------
# the quantized-plane spectral linear (plain version of the kernel's lane)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n_in,n_out", [(16, 200, 72), (128, 300, 200)])
def test_quantized_bc_linear_matches_repro(bits, k, n_in, n_out):
    rng = np.random.RandomState(k + bits)
    p, q = -(-n_out // k), -(-n_in // k)
    w = (rng.randn(p, q, k) / np.sqrt(n_in)).astype(np.float32)
    x = rng.randn(3, 5, n_in).astype(np.float32)
    qcache = jq.quantize_plane_cache(jcc.spectral_cache(jnp.asarray(w)),
                                     bits)
    tcache = {n: _t(v) for n, v in qcache.items()}
    assert tcache["wr"].dtype == (torch.int8 if bits == 8 else torch.uint8)
    before = tbf.KERNEL.launches
    for gauss in (True, False):
        ref = np.asarray(jcc.bc_matmul_spectral(jnp.asarray(x), qcache, k,
                                                n_out, gauss))
        got = tops.bc_linear(_t(x), tcache, k, n_out, gauss).numpy()
        tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    assert tbf.KERNEL.launches == before             # the plain version ran


# ---------------------------------------------------------------------------
# planes: the port's own bake, repro's carried over, the calibration report
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(cfgs):
    cfg, tcfg = cfgs
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(setup, tree=None):
    cfg, tcfg, params = setup
    tree = params if tree is None else tree
    return from_jax_params(jax.tree.map(np.asarray, tree), tcfg,
                           device="cpu")


def _linears(model):
    for name, m in model.named_modules():
        if isinstance(m, tcc.Linear) and m.wc_cache is not None:
            yield name, m


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_planes_carry_over_and_bake(setup, bits):
    cfg, tcfg, params = setup
    policy = jq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    tpolicy = tq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    qtree = jbake(params, cfg, policy)
    carried = _model(setup, qtree)
    seg = qtree["segments"][0][0]
    for name, m in _linears(carried):
        layer, part, proj = name.split(".")[1:]
        ref = seg[part][proj]["wc_cache"]
        for key, t in m.wc_cache.items():
            _eq(t, np.asarray(ref[key])[int(layer)])
    assert tbake(carried, tcfg, tpolicy) is carried   # already quantized
    with pytest.raises(ValueError, match="quantized in place"):
        tbake(carried, tcfg, None)
    # the port's own bake: the same scales up to float32 rounding of the
    # planes, and codes at most one step apart
    own = tbake(_model(setup), tcfg, tpolicy)
    for (_, m), (_, c) in zip(_linears(own), _linears(carried)):
        for key, t in m.wc_cache.items():
            ref = c.wc_cache[key]
            assert t.dtype == ref.dtype and t.shape == ref.shape
            if key.endswith("_s"):
                np.testing.assert_allclose(t.numpy(), ref.numpy(),
                                           rtol=1e-5)
            else:
                if bits == 4:
                    t, ref = tq.unpack_int4(t, 65), tq.unpack_int4(ref, 65)
                assert int((t.int() - ref.int()).abs().max()) <= 1


@pytest.mark.parametrize("quant", [False, True])
def test_weight_absmax_report_matches_repro(setup, quant):
    """repro reports per cache stacked over layers, the port per layer:
    the port's sums and extremes over layers equal repro's entries."""
    cfg, _, params = setup
    tree = jbake(params, cfg, jq.QuantPolicy(quant_weights=True)
                 if quant else None)
    rep = jcal.weight_absmax_report(tree)
    trep = tcal.weight_absmax_report(_model(setup, tree))
    assert len(trep) == cfg.num_layers * len(rep)
    for path, entry in rep.items():
        proj = ".".join(path.split("/")[-3:-1])          # e.g. attn.q
        mine = [e for p, e in trep.items()
                if p.split("/")[0].split(".", 2)[2] == proj]
        assert len(mine) == cfg.num_layers
        for plane, st in entry.items():
            got = [e[plane] for e in mine]
            assert sum(g["bytes"] for g in got) == st["bytes"]
            for key, red in (("absmax", max), ("scale_max", max),
                             ("scale_min", min)):
                assert red(g[key] for g in got) == pytest.approx(
                    st[key], rel=1e-6)


def test_plane_clip_report_matches_repro(setup):
    cfg, tcfg, params = setup
    for bits in (8, 4):
        qtree = jbake(params, cfg, jq.QuantPolicy(quant_weights=True,
                                                  weight_bits=bits))
        got = tq.plane_clip_report(_model(setup, qtree))
        want = jq.plane_clip_report(qtree)
        assert got["clipped"] == want["clipped"] > 0
        assert got["total"] == want["total"]
        # repro counts a plane stacked over layers once, the port per layer
        assert got["planes"] == cfg.num_layers * want["planes"]


# ---------------------------------------------------------------------------
# the engine against repro's, on identical quantized planes
# ---------------------------------------------------------------------------
def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _both(setup, specs, bits=8, **kw):
    cfg, tcfg, params = setup
    jpol = jq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    tpol = tq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    want = jeng.ContinuousEngine(cfg, params, quant=jpol, **kw).generate(
        _reqs(jeng.Request, specs))
    model = _model(setup, jbake(params, cfg, jpol))
    eng = teng.ContinuousEngine(tcfg, model, device="cpu", quant=tpol, **kw)
    return want, eng.generate(_reqs(teng.Request, specs)), eng


def test_engine_int8_matches_repro_across_recycling_preemption_eos(setup):
    """2 slots, 8 usable pages: slots recycle and decode-time growth
    preempts; then the same requests with an EOS token taken from the
    first run's output."""
    specs = [(16, 12), (14, 12), (15, 10), (9, 7)]
    kw = dict(max_slots=2, max_seq=32, page_size=4, num_pages=9,
              decode_chunk=4)
    want, got, eng = _both(setup, specs, **kw)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["status"] for g in got] == ["FINISHED_BUDGET"] * 4
    st = eng.stats()
    assert st["preempted"] > 0 and st["pages_in_use"] == 0
    assert st["quant_policy"] == {"kv_dtype": "int8", "quant_weights": True,
                                  "weight_bits": 8}
    assert 0.0 < st["kv_clip_rate"] < 1.0
    eos = got[0]["tokens"][3]
    want, got, _ = _both(setup, specs[:2], eos_id=eos, **kw)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert got[0]["status"] == "FINISHED_EOS" and got[0]["tokens"][-1] == eos


def test_engine_int4_planes_match_repro(setup):
    want, got, eng = _both(setup, [(20, 10), (12, 14), (9, 8)], bits=4,
                           max_slots=2, max_seq=32, page_size=4,
                           decode_chunk=5)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    cfg, tcfg, params = setup
    jst = jeng.ContinuousEngine(cfg, params, max_slots=2, max_seq=32,
                                page_size=4, quant=jq.QuantPolicy(
                                    "int8", True, 4)).stats()
    st = eng.stats()
    for key in ("kv_pool_bytes", "pool_bytes", "quant_policy",
                "attention_impl", "attention_bytes_per_token",
                "peak_attention_bytes", "decode_peak_bytes_est"):
        assert st[key] == jst[key], key


def test_launch_cli_quantized_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--engine", "continuous", "--device", "cpu",
                "--requests", "2", "--new-tokens", "4", "--max-batch", "2",
                "--kv-dtype",
                "int8", "--quant-weights", "--weight-bits", "4"])
    out = capsys.readouterr().out
    assert "statuses={'FINISHED_BUDGET': 2}" in out
    assert "'kv_dtype': 'int8', 'quant_weights': True, 'weight_bits': 4" in out
