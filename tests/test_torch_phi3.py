"""phi-3-vision-4.2b (smoke config: the ``vision_stub`` frontend, MHA) through
the port's model and both engines against ``repro``'s, on the same weights.

The stub's patch embeddings replace the first ``num_patches`` token slots
(``repro``'s ``concatenate``); a prompt shorter than ``num_patches`` comes
out ``num_patches`` long, and both packages serve it.  The engines feed zero
patches, as ``repro``'s do.  Prefill logits are held at 1e-4 of their scale
(float32 sums in another order) and greedy tokens must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "phi-3-vision-4.2b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
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


def _prefill_both(setup, S):
    """Prefill logits of both packages on the same tokens and random
    (non-zero) patches."""
    cfg, tcfg, params = setup
    rng = np.random.RandomState(S)
    toks = rng.randint(1, 500, size=(2, S))
    patches = rng.randn(2, cfg.num_patches, cfg.d_model).astype(np.float32)
    length = max(S, cfg.num_patches)
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32),
                             "patches": jnp.asarray(patches)},
        build_model(cfg).init_cache(2, length, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    cache = eng.model.init_cache(2, length, dtype=torch.float32,
                                 device="cpu")
    with torch.no_grad():
        got, _ = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks),
                         "patches": torch.from_numpy(patches)}, cache)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("S", [13, 5])
def test_prefill_with_patches_matches_repro(setup, S):
    """A prompt longer than ``num_patches`` (the patches replace its first
    slots) and one shorter (the sequence grows to ``num_patches``)."""
    want, got = _prefill_both(setup, S)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_patches_replace_the_first_slots(setup):
    """The patches reach the logits: changing a patch changes the prefill
    (so the batch's ``patches`` are carried, not dropped)."""
    cfg, tcfg, _ = setup
    model = _model(setup)
    toks = torch.from_numpy(np.random.RandomState(0).randint(1, 500,
                                                             size=(1, 12)))
    patches = torch.zeros((1, cfg.num_patches, cfg.d_model))
    m = teng.Engine(tcfg, model, device="cpu").model
    with torch.no_grad():
        a, _ = m.prefill(model, {"tokens": toks, "patches": patches},
                         m.init_cache(1, 12, dtype=torch.float32,
                                      device="cpu"))
        patches[0, 0, 0] = 1.0
        b, _ = m.prefill(model, {"tokens": toks, "patches": patches},
                         m.init_cache(1, 12, dtype=torch.float32,
                                      device="cpu"))
        c, _ = m.prefill(model, {"tokens": toks},
                         m.init_cache(1, 12, dtype=torch.float32,
                                      device="cpu"))
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1, 12, tcfg.padded_vocab())


def test_both_engines_match_repro(setup):
    """The batch engine (two buckets) and the continuous engine, a prompt
    shorter than ``num_patches`` among them; then each request alone
    through the batch engine equals the continuous engine."""
    cfg, tcfg, params = setup
    specs = [(18, 7), (5, 9), (14, 5)]
    model = _model(setup)
    want = jeng.Engine(cfg, params, max_batch=2, max_seq=48).generate(
        _reqs(jeng.Request, specs))
    got = teng.Engine(tcfg, model, max_batch=2, max_seq=48,
                      device="cpu").generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)
    kw = dict(max_slots=2, max_seq=32, page_size=8, decode_chunk=4)
    cwant = jeng.ContinuousEngine(cfg, params, **kw).generate(
        _reqs(jeng.Request, specs))
    cgot = teng.ContinuousEngine(tcfg, model, device="cpu", **kw).generate(
        _reqs(teng.Request, specs))
    assert _toks(cgot) == _toks(cwant)
    # the B=1 oracle reads the last prompt position; for the short prompt
    # that is a patch slot, not its last token, so only the long ones agree
    oracle = teng.Engine(tcfg, model, max_batch=1, max_seq=32, device="cpu")
    reqs = _reqs(teng.Request, specs)
    assert (_toks(oracle.generate([reqs[0], reqs[2]]))
            == [cgot[0]["tokens"], cgot[2]["tokens"]])


def test_int8_planes_and_pool_match_repro(setup):
    cfg, tcfg, params = setup
    jpol = jq.QuantPolicy("int8", quant_weights=True)
    tpol = tq.QuantPolicy("int8", quant_weights=True)
    kw = dict(max_slots=2, max_seq=32, page_size=8, decode_chunk=4)
    specs = [(15, 8), (6, 6), (12, 7)]
    want = jeng.ContinuousEngine(cfg, params, quant=jpol, **kw).generate(
        _reqs(jeng.Request, specs))
    model = _model(setup, jbake(params, cfg, jpol))
    got = teng.ContinuousEngine(tcfg, model, device="cpu", quant=tpol,
                                **kw).generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)


def test_audio_frontend_still_refused():
    """Only the vision stub is ported: whisper's audio frontend (with its
    learned positions and encoder-decoder stack) still raises."""
    with pytest.raises(NotImplementedError):
        Transformer(tget("whisper-large-v3"), device=torch.device("cpu"))


def test_launch_cli_phi3_on_cpu(capsys):
    from repro_torch.launch import serve
    for engine in ("batch", "continuous"):
        serve.main(["--arch", ARCH, "--engine", engine, "--device", "cpu",
                    "--requests", "2", "--new-tokens", "3"])
        assert "statuses={'FINISHED_BUDGET': 2}" in capsys.readouterr().out
