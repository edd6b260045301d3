"""recurrentgemma-2b (smoke config: (rec, rec, attn_local) x 2, the RG-LRU
and a sliding window of 16 over a ring cache, head dim 32) in the port
against ``repro`` on the same weights and inputs.

Weights come from ``repro``'s seeded init (carried by
``from_jax_params``), inputs from numpy, float32 throughout.  The RG-LRU
block alone: a prefill from no state, a prefill carrying that state in,
then decode steps; outputs and both state leaves (``h``, ``conv``) within
1e-5 of their scale.  The scan alone at a length that is not a power of
two.  Then prefill logits within 1e-4 of their scale (also at 5 layers,
whose last segment is the remainder (rec, rec)), greedy tokens equal to
``repro``'s ``Engine`` under both decode modes and on float32, int8 and
int4 planes, the continuous engine's refusal, and the launcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.layers import recurrent as jrec  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import recurrent as trec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "recurrentgemma-2b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(tcfg, tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), tcfg,
                           device="cpu")


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _toks(results):
    return [r["tokens"] for r in results]


def _close(got, want, rel):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def test_rglru_block_matches_repro_then_carries_its_state(setup):
    """Layer 0's RG-LRU: a 9-position prefill from no state, a 7-position
    prefill carrying its state in, then 3 one-position steps."""
    cfg, tcfg, params = setup
    W = cfg.recurrent.lru_width
    assert tfm.layer_kinds(tcfg)[0] == "rec"
    jp = jax.tree.map(lambda a: a[0], params["segments"][0][0]["rec"])
    cell = _model(tcfg, params).blocks[0].rec
    xs = np.random.RandomState(3).randn(2, 19, cfg.d_model)
    xs = xs.astype(np.float32)
    jfn = jax.jit(lambda x, st: jrec.rglru_block(
        jp, x, width=W, comp=cfg.compression, mode="serve", state=st))
    jstate = tstate = None
    for lo, hi in [(0, 9), (9, 16), (16, 17), (17, 18), (18, 19)]:
        want, jstate = jfn(jnp.asarray(xs[:, lo:hi]), jstate)
        with torch.no_grad():
            got, tstate = trec.rglru_block(cell, torch.from_numpy(
                xs[:, lo:hi]), state=tstate)
        _close(got.numpy(), want, 1e-5)
        _close(tstate[0].numpy(), jstate["h"], 1e-5)
        _close(tstate[1].numpy(), jstate["conv"], 1e-5)


def test_rglru_scan_matches_repro_at_a_ragged_length():
    """S = 37 (not a power of two): the doubling scan against ``repro``'s
    associative scan, decays in the block's range."""
    rng = np.random.RandomState(5)
    log_a = np.log(rng.uniform(0.5, 0.999, size=(2, 37, 24)))
    b = rng.randn(2, 37, 24)
    want = jrec.rglru_scan(jnp.asarray(log_a, jnp.float32),
                           jnp.asarray(b, jnp.float32))
    got = trec.rglru_scan(torch.tensor(log_a, dtype=torch.float32),
                          torch.tensor(b, dtype=torch.float32))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("layers", [None, 5])
def test_prefill_logits_match_repro(setup, layers):
    """The smoke config's 6 layers (two whole segments), and 5 layers:
    (rec, rec, attn_local) once, then the remainder segment (rec, rec),
    carried by ``from_jax_params``; the per-layer states against repro's
    per-segment stacks."""
    cfg, tcfg, params = setup
    if layers is not None:
        cfg, tcfg = cfg.replace(num_layers=layers), tcfg.replace(
            num_layers=layers)
        params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(1))
        assert tfm.segments_for(tcfg) == [(("rec", "rec", "attn_local"), 1),
                                          (("rec", "rec"), 1)]
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 21))
    toks[1, :3] = 0                                      # left-pad
    want, jcache = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 21, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(tcfg, params), device="cpu")
    cache = eng.model.init_cache(2, 21, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(got.numpy(), want, 1e-4)
    assert len(cache) == tcfg.num_layers
    i = 0
    for seg, (pattern, n) in zip(jcache, tfm.segments_for(tcfg)):
        for g in range(n):
            for bi, kind in enumerate(pattern):
                if kind == "rec":
                    for t, key in zip(cache[i], ("h", "conv")):
                        _close(t.numpy(), np.asarray(seg[bi][key])[g], 1e-4)
                else:
                    assert cache[i]["pos"].tolist() == list(range(5, 21))
                i += 1


@pytest.mark.parametrize("decode_mode,bits", [("scan", None),
                                              ("per_token", None),
                                              ("scan", 8), ("scan", 4)])
def test_engine_matches_repro(setup, decode_mode, bits):
    """A left-padded batch whose prompts cover the window, ragged budgets,
    decode past a wrap of the ring: the port's tokens are repro's.  Both
    serve the planes of one bake of repro's (quantized under ``bits``)."""
    cfg, tcfg, params = setup
    specs = [(20, 9), (17, 6)]
    jpol = tpol = None
    if bits is not None:
        jpol = jq.QuantPolicy(quant_weights=True, weight_bits=bits)
        tpol = tq.QuantPolicy(quant_weights=True, weight_bits=bits)
    tree = jax.jit(lambda p: jbake(p, cfg, jpol))(params)
    want = jeng.Engine(cfg, tree, max_batch=2, max_seq=48, quant=jpol,
                       decode_mode=decode_mode, precompute=False).generate(
        _reqs(jeng.Request, specs))
    eng = teng.Engine(tcfg, _model(tcfg, tree), max_batch=2, max_seq=48,
                      quant=tpol, decode_mode=decode_mode, device="cpu")
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)
    a, r = tcfg.attention, tcfg.recurrent
    ring = 2 * 2 * 16 * a.num_kv_heads * a.head_dim * 4 + 16 * 4
    state = 2 * r.lru_width * 4 * r.conv1d_width
    assert eng.stats()["cache_bytes"] == 2 * ring + 4 * state


def test_continuous_engine_and_launcher(setup, capsys):
    from repro_torch.launch import serve
    _, tcfg, params = setup
    with pytest.raises(ValueError, match="not continuous-servable"):
        teng.ContinuousEngine(tcfg, _model(tcfg, params), device="cpu")
    serve.main(["--arch", ARCH, "--engine", "batch", "--device", "cpu",
                "--requests", "2", "--new-tokens", "3"])
    assert "statuses={'FINISHED_BUDGET': 2}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="use --engine batch"):
        serve.main(["--arch", ARCH, "--engine", "continuous", "--device",
                    "cpu"])
