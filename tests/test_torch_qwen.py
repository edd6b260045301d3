"""qwen2.5-3b (QKV bias) and qwen3-4b (per-head qk-norm) through both of
the port's engines against ``repro``'s, on the same weights (smoke
configs, float32).

``repro`` initializes the biases and the qk-norm scales to zero, which
would hide a dropped leaf, so the tree is perturbed with numpy before both
packages get it.  Greedy tokens must be identical (the float32 logits of
the two packages differ by ~3e-6 of their scale, far below the top-1/top-2
gaps); prefill logits are held at 1e-4 of their scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCHS = ("qwen2.5-3b", "qwen3-4b")


def _perturb(tree, rng):
    """Random values in every bias and qk-norm scale (numpy leaves)."""
    for seg in tree["segments"]:
        for block in seg:
            attn = block["attn"]
            for name in ("q", "k", "v"):
                if "b" in attn[name]:
                    attn[name]["b"] = (0.5 * rng.randn(
                        *attn[name]["b"].shape)).astype(np.float32)
            for name in ("qn", "kn"):
                if name in attn:
                    attn[name]["scale"] = (0.3 * rng.randn(
                        *attn[name]["scale"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_smoke_config(arch).replace(dtype="float32")
    tcfg = tget(arch).replace(dtype="float32")
    tree = _perturb(jax.tree.map(np.array, build_model(cfg).init(
        jax.random.PRNGKey(0))), np.random.RandomState(1))
    params = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, tree, params


def _model(setup):
    _, tcfg, tree, _ = setup
    return from_jax_params(tree, tcfg, device="cpu")


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _toks(results):
    return [r["tokens"] for r in results]


def test_bias_and_qk_norm_carried(setup):
    cfg, tcfg, tree, _ = setup
    model = _model(setup)
    a = cfg.attention
    attn0 = model.blocks[0].attn
    seg = tree["segments"][0][0]["attn"]
    for name in ("q", "k", "v"):
        lin = getattr(attn0, name)
        assert hasattr(lin, "b") == a.qkv_bias
        if a.qkv_bias:
            np.testing.assert_array_equal(lin.b.numpy(), seg[name]["b"][0])
    assert not hasattr(attn0.o, "b")                # o never has a bias
    assert hasattr(attn0, "qn") == a.qk_norm
    if a.qk_norm:
        np.testing.assert_array_equal(attn0.qn.scale.numpy(),
                                      seg["qn"]["scale"][0])
        np.testing.assert_array_equal(model.blocks[1].attn.kn.scale.numpy(),
                                      seg["kn"]["scale"][1])


def test_prefill_logits_match_repro(setup):
    cfg, tcfg, _, params = setup
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 11))
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 11, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    cache = eng.model.init_cache(2, 11, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, _ = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_both_engines_match_repro(setup):
    """The batch engine (two buckets, ragged budgets) and the continuous
    engine (slots recycled) against repro's; then each request alone
    through the port's batch engine equals its continuous engine."""
    cfg, tcfg, _, params = setup
    specs = [(18, 7), (11, 9), (14, 5)]
    model = _model(setup)
    want = jeng.Engine(cfg, params, max_batch=2, max_seq=48).generate(
        _reqs(jeng.Request, specs))
    got = teng.Engine(tcfg, model, max_batch=2, max_seq=48,
                      device="cpu").generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)
    kw = dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=4)
    cwant = jeng.ContinuousEngine(cfg, params, **kw).generate(
        _reqs(jeng.Request, specs))
    cgot = teng.ContinuousEngine(tcfg, model, device="cpu", **kw).generate(
        _reqs(teng.Request, specs))
    assert _toks(cgot) == _toks(cwant)
    oracle = teng.Engine(tcfg, model, max_batch=1, max_seq=32, device="cpu")
    assert _toks(oracle.generate(_reqs(teng.Request, specs))) == _toks(cgot)
