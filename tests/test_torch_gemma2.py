"""gemma2-9b (smoke config: attn_local then attn, a sliding window of 16
over a ring cache, attention softcap 50, final-logit softcap 30, sandwich
norms, sqrt(d_model) input scale, head dim 32) in the port against
``repro`` on the same weights and inputs.

Weights come from ``repro``'s seeded init (carried by
``from_jax_params``), inputs from numpy, float32 throughout.  The local
layer's ring cache alone, with its softcap: a prefill then decode steps
past a wrap of the ring; every step's output and, at the end, the ring
within 1e-5 of their scale.  Then prefill logits within 1e-4 of their
scale: at the published caps, at caps small enough (attention 0.5, final
1.0) that tanh is far from the identity at this scale, and with random
post-norm scales (the sandwich norms carried across and applied); greedy
tokens equal to ``repro``'s ``Engine`` under both decode modes and on
float32, int8 and int4 planes, the continuous engine's refusal, and the
launcher.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "gemma2-9b"


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


def test_local_layer_ring_matches_repro_across_a_wrap(setup):
    """Layer 0 (attn_local, softcap 0.5 so it bites) with a ring of 16
    slots: a prefill of 21 positions, then 14 decode steps."""
    cfg, tcfg, params = setup
    W = cfg.attention.sliding_window
    assert W == 16 and tfm.layer_kinds(tcfg) == ["attn_local", "attn"]
    cfg, tcfg = (c.replace(attention=dataclasses.replace(
        c.attention, logit_softcap=0.5)) for c in (cfg, tcfg))
    jp = jax.tree.map(lambda a: a[0], params["segments"][0][0]["attn"])
    attn = _model(tcfg, params).blocks[0].attn
    rng = np.random.RandomState(6)
    S, steps, B = 21, 14, 2
    xs = rng.randn(B, S + steps, cfg.d_model).astype(np.float32)
    jc = jattn.init_kv_cache(B, S + steps, cfg, W, jnp.float32)
    tc = tattn.init_kv_cache(B, S + steps, tcfg, device=torch.device("cpu"),
                             window=W, dtype=torch.float32)
    step = jax.jit(lambda x, c, pos: jattn.attention_block(
        jp, x, cfg=cfg, window=W, cache=c, cache_pos=pos, mode="serve"))
    for p in range(S - 1, S + steps):             # the prefill, then steps
        lo = 0 if p == S - 1 else p
        want, jc = step(jnp.asarray(xs[:, lo:p + 1]), jc, jnp.int32(lo))
        with torch.no_grad():
            got, tc = tattn.attention_block(
                attn, torch.from_numpy(xs[:, lo:p + 1]), cfg=tcfg, window=W,
                cache=tc, cache_pos=lo)
        _close(got.numpy(), want, 1e-5)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key], 1e-5)


def _post_norms(params, seed):
    """``params`` with every post-norm scale drawn at random (repro's init
    leaves them 0, where the norm is a plain rms normalisation)."""
    rng = np.random.RandomState(seed)
    seg = jax.tree.map(lambda a: a, params["segments"][0])
    for blk in seg:
        for name in ("ln1_post", "ln2_post"):
            s = blk[name]["scale"]
            blk[name]["scale"] = jnp.asarray(
                rng.uniform(-0.5, 0.5, size=s.shape), jnp.float32)
    return {**params, "segments": [seg]}


@pytest.mark.parametrize("case", ["published", "small_caps", "post_norms"])
def test_prefill_logits_match_repro(setup, case):
    cfg, tcfg, params = setup
    if case == "small_caps":
        cfg, tcfg = (c.replace(logit_softcap=1.0, attention=dataclasses
                               .replace(c.attention, logit_softcap=0.5))
                     for c in (cfg, tcfg))
    if case == "post_norms":
        params = _post_norms(params, 7)
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 21))
    toks[1, :3] = 0                                      # left-pad
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 21, dtype=jnp.float32))
    model = _model(tcfg, params)
    for blk, jblk in zip(model.blocks, params["segments"][0]):
        for name in ("ln1_post", "ln2_post"):
            _close(getattr(blk, name).scale.numpy(),
                   np.asarray(jblk[name]["scale"])[0], 0)
    eng = teng.Engine(tcfg, model, device="cpu")
    cache = eng.model.init_cache(2, 21, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(got.numpy(), want, 1e-4)
    if case == "small_caps":                  # the final cap bounds them
        assert float(got.abs().max()) < 1.0
    # the local layer's ring keeps the last 16 positions, the global
    # layer's linear cache all 21
    assert [c["pos"].tolist() for c in cache] == [list(range(5, 21)),
                                                  list(range(21))]


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
    tree = jax.jit(lambda p: jbake(p, cfg, jpol))(_post_norms(params, 8))
    want = jeng.Engine(cfg, tree, max_batch=2, max_seq=48, quant=jpol,
                       decode_mode=decode_mode, precompute=False).generate(
        _reqs(jeng.Request, specs))
    eng = teng.Engine(tcfg, _model(tcfg, tree), max_batch=2, max_seq=48,
                      quant=tpol, decode_mode=decode_mode, device="cpu")
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)
    a = tcfg.attention
    kv = 2 * 2 * a.num_kv_heads * a.head_dim * 4        # k + v, a position
    assert eng.stats()["cache_bytes"] == (16 * kv + 16 * 4) + (28 * kv
                                                             + 28 * 4)


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


@pytest.mark.parametrize("name,sandwich", [("gemma2-9b", False),
                                           ("custom", True)])
def test_post_norms_follow_the_config_field(setup, name, sandwich):
    """The post-norms come from ``sandwich_norm`` alone, whatever the
    model is called."""
    _, tcfg, _ = setup
    blk = tfm.Block("attn", tcfg.replace(name=name, sandwich_norm=sandwich),
                    device=torch.device("cpu"))
    assert hasattr(blk, "ln1_post") == hasattr(blk, "ln2_post") == sandwich
