"""A float8_e4m3fn dense KV cache (``kv_cache_dtype="float8_e4m3fn"``, the
``kvf8`` variants of ``repro``'s hillclimb) in the port against ``repro``.

* The cast: the port writes a cache as ``repro``'s ``astype`` casts
  (``layers/attention.py:to_cache``): equal, value for value, to
  ``ml_dtypes``' cast and to XLA's on the CPU, over exact values, ties,
  subnormals, the +-448 edge, magnitudes past 464 and +-inf (NaN in both),
  NaN and 4,096 random draws.  torch's own cast saturates those past 464
  to +-448, hence the wrapper.
* The read: ``kv_read`` never narrows the query; over an e4m3 cache the
  float32 query reads it through ``flash_attention``, whose CPU version
  equals ``attention_ref`` on the cache widened to float32.
* Greedy tokens: the batch ``Engine`` with ``cache_dtype=float8_e4m3fn``
  against ``repro``'s ``Engine`` serving over a float8 cache (its model's
  ``init_cache`` given that dtype: ``repro``'s batch engine otherwise keeps
  float32, as the port's does by default), on tinyllama's smoke config
  (linear cache) and mixtral's (the ring of 16 slots, MoE), float32:
  equal to ``repro``'s, row by row, up to the
  row's first near-tie (``NEAR_TIE``; the one met here is mixtral's last
  step, a gap of 6.5e-4 after a flipped code moved the logits 3.8e-3),
  and ``repro``'s engine equal to a hand-run trace of its model.
"""
import functools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jget  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

E4M3 = torch.float8_e4m3fn


def _edge_values():
    edges = [0.0, -0.0, 1.0, -1.0, 448.0, -448.0, 449.0, 456.0, 464.0,
             -464.0, 464.001, 465.0, 479.0, 480.0, 500.0, -1e4, 1e30,
             float("inf"), -float("inf"), float("nan"), 2.0 ** -9,
             2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -6, 1.0625, 1.1875, 0.3,
             -17.5, 240.0, 248.0, 256.0]
    rng = np.random.RandomState(0)
    rand = np.concatenate([rng.randn(2048) * 3, rng.randn(2048) * 200])
    return np.concatenate([np.array(edges), rand]).astype(np.float32)


def test_cast_matches_ml_dtypes_and_xla():
    x = _edge_values()
    got = tattn.to_cache(torch.from_numpy(x), E4M3).float().numpy()
    want = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    xla = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn).astype(
        jnp.float32))
    for ref in (want, xla):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        np.testing.assert_array_equal(got[ok], ref[ok])
    assert np.isnan(got[x == 465.0]).all() and np.isnan(got[np.isinf(x)]
                                                        ).all()
    # other dtypes pass through torch's cast
    assert tattn.to_cache(torch.tensor([500.0]), torch.bfloat16).item() == \
        500.0


def test_kv_read_never_narrows_the_query():
    q32 = torch.randn(1, 2, 4, 8)
    q16 = q32.bfloat16()
    for q, k_dtype, want_q, want_k in (
            (q32, E4M3, torch.float32, E4M3),
            (q16, E4M3, torch.float32, E4M3),
            (q16, torch.float32, torch.float32, torch.float32),
            (q32, torch.bfloat16, torch.float32, torch.float32),
            (q32, torch.float32, torch.float32, torch.float32)):
        k = torch.randn(1, 3, 4, 8).to(k_dtype)
        qq, kk, vv = tattn.kv_read(q, k, k)
        assert (qq.dtype, kk.dtype, vv.dtype) == (want_q, want_k, want_k)


@pytest.mark.parametrize("causal,window,kv_offset", [(True, 0, 5),
                                                     (False, 0, 0),
                                                     (True, 4, 3)])
def test_flash_over_e4m3_is_attention_ref_on_the_widened_cache(
        causal, window, kv_offset):
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(2, 4, 3, 16).astype(np.float32))
    k, v = (tattn.to_cache(torch.from_numpy(rng.randn(2, 2, 8, 16).astype(
        np.float32)), E4M3) for _ in range(2))
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.attention_ref(q, k.float(), v.float(), **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = jget(arch).replace(dtype="float32", kv_cache_dtype="float8_e4m3fn")
    tcfg = tget(arch).replace(dtype="float32",
                              kv_cache_dtype="float8_e4m3fn")
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _repro_f8_engine(cfg, params, **kw):
    """``repro``'s batch ``Engine`` over a float8 dense cache: its model's
    ``init_cache`` takes the config's ``kv_cache_dtype`` instead of the
    float32 the engine asks for."""
    eng = jeng.Engine(cfg, params, **kw)
    init = eng.model.init_cache
    eng.model.init_cache = lambda B, S, dtype=None: init(
        B, S, dtype=jnp.dtype(cfg.kv_cache_dtype))
    return eng


# A K/V value within float32 noise of an e4m3 rounding midpoint takes
# another code in the two frameworks (their float32 projections differ by
# ~1e-6): one flipped code in mixtral's ring moved its logits by up to
# 5.2e-3.  Tokens are held equal up to each row's first step whose top-2
# logit gap in repro is below this.
NEAR_TIE = 0.02


def _repro_trace(cfg, params, specs, steps, seed=0):
    """Greedy tokens and each step's top-2 logit gap of ``repro``'s model
    over a float8 cache, the batch left-padded as the engines pad it."""
    m = build_model(cfg)
    p = jbake(params, cfg)
    prompts = [r.prompt for r in _reqs(jeng.Request, specs, seed)]
    B, S = len(prompts), max(len(x) for x in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, x in enumerate(prompts):
        toks[i, S - len(x):] = x
    cache = m.init_cache(B, S + steps - 1,
                         dtype=jnp.dtype(cfg.kv_cache_dtype))
    logits, cache = jax.jit(m.prefill)(p, {"tokens": jnp.asarray(toks)},
                                       cache)
    step = jax.jit(m.decode_step)
    out, gaps = [], []
    for j in range(steps):
        last = np.asarray(logits)[:, -1]
        top = np.sort(last, axis=-1)
        gaps.append(top[:, -1] - top[:, -2])
        out.append(last.argmax(-1))
        if j + 1 < steps:
            logits, cache = step(p, jnp.asarray(out[-1][:, None].astype(
                np.int32)), cache, S + j)
    return np.stack(out, 1), np.stack(gaps, 1)


# (arch, prompt lengths and budgets, decode modes): mixtral's prompts cover
# its window of 16 (the ring rule), and 6 steps wrap past it
CASES = [("tinyllama-1.1b", [(9, 8), (5, 8), (12, 8)], ("scan",)),
         ("mixtral-8x7b", [(18, 6), (20, 6)], ("scan",))]


@pytest.mark.parametrize("arch,specs,modes", CASES, ids=[c[0] for c in CASES])
def test_engine_tokens_over_f8_cache_match_repro(arch, specs, modes):
    cfg, tcfg, params = _setup(arch)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    steps = specs[0][1]
    trace, gaps = _repro_trace(cfg, params, specs, steps)
    for mode in modes:
        want = _repro_f8_engine(cfg, params, max_seq=64, decode_mode=mode,
                                bucket_prompts=False).generate(
            _reqs(jeng.Request, specs))
        assert [r["tokens"] for r in want] == trace.tolist(), mode
        eng = teng.Engine(tcfg, model, device="cpu", max_seq=64,
                          decode_mode=mode, cache_dtype=E4M3,
                          bucket_prompts=False)
        got = eng.generate(_reqs(teng.Request, specs))
        for row, (g, w) in enumerate(zip(got, want)):
            ties = np.flatnonzero(gaps[row] < NEAR_TIE)
            n = int(ties[0]) if len(ties) else steps   # the tied token
            assert n >= steps - 1, (mode, row, gaps[row])  # may differ
            assert g["tokens"][:n] == w["tokens"][:n], (mode, row, n)
        assert eng.stats()["cache_dtype"] == "float8_e4m3fn"
