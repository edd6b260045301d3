"""The port's batch ``Engine`` (the B=1 oracle) against ``repro``'s on the
same weights (smoke tinyllama, float32), and its sampler.

Greedy tokens must be identical: bucketing, left-padding (pads are real
tokens, as in ``repro``), ragged budgets, EOS, the step clamp and both
decode modes, with float32 planes (the prefill's MAC through the
``spectral_matmul`` hook, here its plain version) and with int8 / int4
planes (``repro``'s, carried by ``from_jax_params``).  Prefill logits are
held at 1e-4 of their scale: the two packages' float32 sums differ by
~3e-6 there (``test_torch_model.py``).

The sampler cannot reproduce ``jax.random``'s bits, so sampling is held to
its own contract: one seed gives one sequence, another seed another,
``per_token`` equals ``scan``, and its draws follow ``softmax(logits / T)``.
"""
import dataclasses

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
from repro_torch.kernels import spectral_matmul as tsm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import init_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(setup, tree=None):
    _, tcfg, params = setup
    tree = params if tree is None else tree
    return from_jax_params(jax.tree.map(np.asarray, tree), tcfg,
                           device="cpu")


@pytest.fixture(scope="module")
def model(setup):
    return _model(setup)


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _toks(results):
    return [r["tokens"] for r in results]


# ---------------------------------------------------------------------------
# greedy tokens against repro's Engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucket", [True, False])
def test_engine_matches_repro_across_buckets_and_ragged_budgets(
        setup, model, bucket):
    """Five requests, two per batch: bucketing groups them by (prompt
    length, budget), without it they batch in order; either way the short
    prompts are left-padded to their batch-mate's length."""
    cfg, tcfg, params = setup
    specs = [(20, 8), (12, 3), (16, 8), (9, 6), (20, 5)]
    kw = dict(max_batch=2, max_seq=64, bucket_prompts=bucket)
    jeng_ = jeng.Engine(cfg, params, **kw)
    want = jeng_.generate(_reqs(jeng.Request, specs))
    eng = teng.Engine(tcfg, model, device="cpu", **kw)
    before = tsm.KERNEL.launches
    got = eng.generate(_reqs(teng.Request, specs))
    assert tsm.KERNEL.launches == before          # CPU: the plain version
    assert _toks(got) == _toks(want)
    assert [g["decode_len"] for g in got] == [8, 3, 8, 6, 5]
    assert [g["status"] for g in got] == ["FINISHED_BUDGET"] * 5
    st, jst = eng.stats(), jeng_.stats()
    for key in ("engine", "requests", "tokens", "prompt_tokens",
                "padded_prompt_tokens", "prompt_pad_waste", "dispatches",
                "batches"):
        assert st[key] == jst[key], key
    assert st["prefills"] == 3
    # per_token: one decode-step call per token, no freezing; the same
    # tokens once cut to each request's budget
    eng.decode_mode = "per_token"
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)


def test_prefill_logits_match_repro(setup, model):
    """A left-padded batch through both prefill steps: last-position
    logits within 1e-4 of their scale, the port's MAC through the hook."""
    cfg, tcfg, params = setup
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 500, size=(3, 13)).astype(np.int32)
    toks[1, :4] = 0                                  # left-pad
    jmodel = build_model(cfg)
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks)},
        jmodel.init_cache(3, 13, dtype=jnp.float32))
    eng = teng.Engine(tcfg, model, device="cpu")      # bakes the planes
    calls = []

    def hook(xr, xi, cache):
        calls.append(1)
        return tops.spectral_contract(xr, xi, cache)
    step = tdec.make_prefill_step(tcfg, kernel_fn=hook)
    cache = eng.model.init_cache(3, 13, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = step(eng.params, {"tokens": torch.from_numpy(
            toks.astype(np.int64))}, cache)
    assert got.shape == (3, 1, tcfg.vocab_size)
    assert len(calls) == 7 * tcfg.num_layers          # every projection
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert cache["pos"][:, :13].tolist() == [list(range(13))] * 2


def test_eos_matches_repro(setup, model):
    cfg, tcfg, params = setup
    specs = [(16, 8), (12, 8)]
    base = teng.Engine(tcfg, model, device="cpu").generate(
        _reqs(teng.Request, specs))
    eos = base[0]["tokens"][2]                       # emitted mid-way
    want = jeng.Engine(cfg, params, max_seq=64, eos_id=eos).generate(
        _reqs(jeng.Request, specs))
    got = teng.Engine(tcfg, model, device="cpu", max_seq=64,
                      eos_id=eos).generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)
    toks = got[0]["tokens"]
    assert toks == base[0]["tokens"][:base[0]["tokens"].index(eos) + 1]
    assert got[0]["status"] == "FINISHED_EOS"
    assert [g["status"] for g in got] == [w["status"] for w in want]


def test_cache_clamp_matches_repro(setup, model):
    """S = 20 at max_seq 24: the budget of 16 clamps to 24 - 20 + 1 = 5
    and the tokens equal an unclamped run of 5."""
    cfg, tcfg, params = setup
    req = _reqs(teng.Request, [(20, 16)])
    want = jeng.Engine(cfg, params, max_seq=24).generate(
        _reqs(jeng.Request, [(20, 16)]))
    got = teng.Engine(tcfg, model, device="cpu", max_seq=24).generate(req)
    assert got[0]["decode_len"] == 5
    assert _toks(got) == _toks(want)
    roomy = teng.Engine(tcfg, model, device="cpu", max_seq=64).generate(
        [dataclasses.replace(req[0], max_new_tokens=5)])
    assert _toks(got) == _toks(roomy)
    with pytest.raises(ValueError, match="max_seq"):
        teng.Engine(tcfg, model, device="cpu", max_seq=16).generate(req)


def test_b1_engine_equals_continuous_engine(setup, model):
    """The oracle contract inside the port: each request alone through the
    batch engine gives the continuous engine's greedy tokens."""
    _, tcfg, _ = setup
    specs = [(20, 9), (12, 14), (9, 6)]
    cont = teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=32,
                                 page_size=4, decode_chunk=4, device="cpu")
    want = cont.generate(_reqs(teng.Request, specs))
    oracle = teng.Engine(tcfg, model, max_batch=1, max_seq=32, device="cpu")
    got = oracle.generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)
    assert oracle.stats()["prefills"] == 3
    assert cont.stats()["engine"] == "continuous"


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_planes_match_repro(setup, bits):
    """int8 / int4 planes: the hook is skipped at prefill (quantized
    caches), the fused kernel's quantized lane runs instead."""
    cfg, tcfg, params = setup
    jpol = jq.QuantPolicy(quant_weights=True, weight_bits=bits)
    tpol = tq.QuantPolicy(quant_weights=True, weight_bits=bits)
    specs = [(14, 7), (11, 7)]
    want = jeng.Engine(cfg, params, quant=jpol).generate(
        _reqs(jeng.Request, specs))
    eng = teng.Engine(tcfg, _model(setup, jbake(params, cfg, jpol)),
                      device="cpu", quant=tpol)
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)
    assert eng.stats()["quant_policy"]["weight_bits"] == bits


def test_engine_refuses_unported_blocks_and_modes(setup, model):
    """Every block kind is ported: gemma2's engine builds (its kinds are
    attn_local and attn); an unknown decode mode and weights on another
    device are refused."""
    _, tcfg, _ = setup
    gcfg = tget("gemma2-9b")
    eng = teng.Engine(gcfg, init_params(gcfg, seed=0, device="cpu"),
                      device="cpu")
    assert eng._swa_window == gcfg.attention.sliding_window
    with pytest.raises(ValueError, match="decode_mode"):
        teng.Engine(tcfg, model, device="cpu", decode_mode="loop")
    with pytest.raises(ValueError, match="params are on"):
        teng.Engine(tcfg, model, device="meta")


def test_launch_cli_batch_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--engine", "batch", "--device", "cpu",
                "--requests", "3", "--new-tokens", "4", "--max-batch", "2",
                "--decode-mode", "per_token", "--no-bucket"])
    out = capsys.readouterr().out
    assert "(batch) on cpu: 3 requests, 12 tokens" in out
    assert "statuses={'FINISHED_BUDGET': 3} batches=2 prefills=2" in out
    with pytest.raises(SystemExit, match="not continuous-servable"):
        serve.main(["--arch", "gemma2-9b", "--engine", "continuous",
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_sampling_seeded_mode_independent_and_first_token_greedy(
        setup, model):
    _, tcfg, _ = setup
    specs = [(12, 10), (16, 10)]

    def run(seed, mode="scan", sample=True):
        eng = teng.Engine(tcfg, model, device="cpu", sample=sample,
                          seed=seed, decode_mode=mode)
        return _toks(eng.generate(_reqs(teng.Request, specs)))
    a, b, c = run(1), run(1), run(2)
    assert a == b                                  # reproducible per seed
    assert a != c                                  # distinct across seeds
    assert run(1, "per_token") == a                # keys ignore call order
    greedy = run(0, sample=False)
    # the prefill's token is the argmax even when sampling, as in repro
    assert [t[0] for t in a] == [t[0] for t in greedy]
    assert a != greedy

    def cont(seed):
        eng = teng.ContinuousEngine(tcfg, model, max_slots=2, max_seq=32,
                                    page_size=4, sample=True, seed=seed,
                                    device="cpu")
        return _toks(eng.generate(_reqs(teng.Request, specs)))
    x = cont(1)
    assert x == cont(1) and x != cont(2)


def test_sampler_draws_follow_softmax():
    """20,000 draws from one logits row at T = 0.7, each keyed by its own
    position: every frequency within 0.015 of softmax(logits / T) (the
    largest standard error here is ~0.0035, so that is over 4 of them)."""
    n, T = 20000, 0.7
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 1.5, -0.5, 0.2]])
    pos = torch.arange(n)
    draws = tdec.sample_tokens(logits.expand(n, -1), T, 3,
                               torch.zeros(n, dtype=torch.int64), pos)
    assert draws.dtype == torch.int32
    freq = torch.bincount(draws.long(), minlength=8).double() / n
    want = torch.softmax(logits[0].double() / T, -1)
    assert float((freq - want).abs().max()) < 0.015
    # the noise is a function of (seed, stream, position) alone
    again = tdec.sample_tokens(logits.expand(n, -1), T, 3,
                               torch.zeros(n, dtype=torch.int64), pos)
    assert torch.equal(draws, again)
    other = tdec.sample_tokens(logits.expand(n, -1), T, 3,
                               torch.ones(n, dtype=torch.int64), pos)
    assert not torch.equal(draws, other)
