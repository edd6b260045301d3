"""whisper-large-v3 (smoke config: 2 encoder and 2 decoder layers, 16
frames, layernorm, learned positions) in the port against ``repro`` on the
same weights and inputs.

Weights come from ``repro``'s seeded init (carried by
``from_jax_params``), inputs from numpy, float32 throughout.  Alone:
layernorm, and a decoder layer's cross-attention over given K/V (a
prefill's rows and one decode row), within 1e-5 of their scale.  Then
prefill logits and the cross K/V the prefill caches within 1e-4 of their
scale (random frames, so the encoder matters), greedy tokens equal to
``repro``'s ``Engine`` under both decode modes and on float32, int8 and
int4 planes (zero frames, as both engines feed them), the continuous
engine's refusal, and the launcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(setup, tree=None):
    _, tcfg, params = setup
    return from_jax_params(jax.tree.map(np.asarray, params if tree is None
                                        else tree), tcfg, device="cpu")


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


def test_layernorm_matches_repro():
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(3, 5, 48) + 1.5).astype(np.float32)
    scale, bias = rng.randn(48).astype(np.float32), rng.randn(48).astype(
        np.float32)
    want = jnorms.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))
    ln = tnorms.init_norm("layernorm", 48, device=torch.device("cpu"))
    assert isinstance(ln, tnorms.LayerNorm)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("S", [5, 1])
def test_cross_attention_matches_repro(setup, S):
    """Decoder layer 1's cross-attention: q from x, the given K/V of the
    16 frames, no RoPE, non-causal."""
    cfg, tcfg, params = setup
    a = cfg.attention
    jp = jax.tree.map(lambda t: t[1], params["dec_blocks"]["cross"])
    attn = _model(setup).dec_blocks[1].cross
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    k, v = (rng.randn(2, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
            .astype(np.float32) for _ in range(2))
    want, _ = jattn.attention_block(jp, jnp.asarray(x), cfg=cfg,
                                    causal=False, mode="serve",
                                    cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    with torch.no_grad():
        got, _ = tattn.attention_block(
            attn, torch.from_numpy(x), cfg=tcfg, causal=False,
            cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    _close(got.numpy(), want, 1e-5)
    assert not attn.may_fuse


def test_prefill_logits_and_cross_cache_match_repro(setup):
    cfg, tcfg, params = setup
    rng = np.random.RandomState(4)
    toks = rng.randint(1, 500, size=(2, 13))
    toks[1, :4] = 0                                      # left-pad
    frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    want, jcache = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32),
                             "frames": jnp.asarray(frames)},
        build_model(cfg).init_cache(2, 13, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    assert isinstance(eng.params, EncDec)
    cache = eng.model.init_cache(2, 13, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks),
                         "frames": torch.from_numpy(frames)}, cache)
    _close(got.numpy(), want, 1e-4)
    for t, j in zip(cache["cross"], jcache["cross"]):
        _close(t.numpy(), j, 1e-4)
    for key in ("k", "v", "pos"):
        _close(cache["self"][key].numpy(), jcache["self"][key], 1e-4)


@pytest.mark.parametrize("decode_mode,bits", [("scan", None),
                                              ("per_token", None),
                                              ("scan", 8), ("scan", 4)])
def test_engine_matches_repro(setup, decode_mode, bits):
    """A left-padded batch, ragged budgets: the port's tokens are repro's.
    Both serve the planes of one bake of repro's (quantized under
    ``bits``)."""
    cfg, tcfg, params = setup
    specs = [(14, 8), (9, 5)]
    jpol = tpol = None
    if bits is not None:
        jpol = jq.QuantPolicy(quant_weights=True, weight_bits=bits)
        tpol = tq.QuantPolicy(quant_weights=True, weight_bits=bits)
    tree = jax.jit(lambda p: jbake(p, cfg, jpol))(params)
    want = jeng.Engine(cfg, tree, max_batch=2, max_seq=32, quant=jpol,
                       decode_mode=decode_mode, precompute=False).generate(
        _reqs(jeng.Request, specs))
    eng = teng.Engine(tcfg, _model(setup, tree), max_batch=2, max_seq=32,
                      quant=tpol, decode_mode=decode_mode, device="cpu")
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)
    a, L = tcfg.attention, tcfg.num_layers
    kv = L * 2 * a.num_kv_heads * a.head_dim * 4        # a position, B = 2
    want_bytes = 2 * kv * (14 + 8 - 1) + L * 21 * 4 + 2 * kv * 16
    assert eng.stats()["cache_bytes"] == want_bytes


def test_continuous_engine_and_launcher(setup, capsys):
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="not continuous-servable"):
        teng.ContinuousEngine(setup[1], _model(setup), device="cpu")
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--new-tokens", "3"])
    assert "statuses={'FINISHED_BUDGET': 2}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="use --engine batch"):
        serve.main(["--arch", ARCH, "--engine", "continuous", "--device",
                    "cpu"])
