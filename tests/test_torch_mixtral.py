"""mixtral-8x7b (smoke config: every block ``moe_swa``, a sliding window of
16 over a ring cache) in the port against ``repro`` on the same weights
and inputs.

Weights come from ``repro``'s seeded init (carried by
``from_jax_params``), inputs from numpy, float32 throughout.  The ring
cache alone: a prefill then decode steps past a wrap of the ring, with a
prompt that fills the ring in slot order (S % Smax == 0) and one that
does not (then a decode step overwrites a position inside the window,
and the ring keeps one outside it: ``layers/attention.py``); every
step's output and, at the end, the ring's k, v and pos within 1e-5 of
their scale.  Then prefill logits within 1e-4 of their scale, greedy
tokens equal to ``repro``'s ``Engine`` under both decode modes and on
float32, int8 and int4 planes, the engine's sliding-window prompt rule,
the continuous engine's refusal, and the launcher.
"""
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
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "mixtral-8x7b"


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


@pytest.mark.parametrize("S", [16, 21])
def test_ring_cache_matches_repro_across_a_wrap(setup, S):
    """Layer 0's windowed attention with a ring of 16 slots: a prefill of
    S positions, then 18 decode steps (past a wrap of the ring)."""
    cfg, tcfg, params = setup
    W = cfg.attention.sliding_window
    assert W == 16
    jp = jax.tree.map(lambda a: a[0], params["segments"][0][0]["attn"])
    attn = _model(setup).blocks[0].attn
    rng = np.random.RandomState(S)
    steps, B = 18, 2
    xs = rng.randn(B, S + steps, cfg.d_model).astype(np.float32)
    jc = jattn.init_kv_cache(B, S + steps, cfg, W, jnp.float32)
    tc = tattn.init_kv_cache(B, S + steps, tcfg, device=torch.device("cpu"),
                             window=W, dtype=torch.float32)
    assert tc["k"].shape[1] == jc["k"].shape[1] == W
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


def test_ring_runs_keep_repros_mask():
    """The slots the read keeps: written, not after the query, inside the
    window; in one or two runs."""
    pos = torch.tensor([4, 5, 6, 7, 20, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                        18, 19], dtype=torch.int32)
    assert tattn.ring_runs(pos, 20, 16) == [(1, 16)]
    pos[0] = 21
    assert tattn.ring_runs(pos, 21, 16) == [(0, 1), (2, 16)]
    assert tattn.ring_runs(torch.full((4,), -1, dtype=torch.int32), 3,
                           16) == []


@pytest.mark.parametrize("layers", [None, 2])
def test_ring_cache_is_laid_out_in_one_place(setup, layers):
    """A ring, alone or stacked over layers, holds min(window, seq) slots
    with its pos row on the host; the model's cache is the stacked one."""
    _, tcfg, _ = setup
    a, W = tcfg.attention, tcfg.attention.sliding_window
    tc = tattn.init_kv_cache(2, 40, tcfg, device=torch.device("cpu"),
                             window=W, dtype=torch.float32, layers=layers)
    lead = () if layers is None else (layers,)
    assert tc["k"].shape == (*lead, 2, W, a.num_kv_heads, a.head_dim)
    assert tc["pos"].shape == (*lead, W) and (tc["pos"] == -1).all()
    assert tc["pos"].device.type == "cpu"
    whole = teng.Engine(tcfg, _model(setup), device="cpu").model.init_cache(
        2, 40, dtype=torch.float32, device="cpu")
    L = tcfg.num_layers
    want = tattn.init_kv_cache(2, 40, tcfg, device=torch.device("cpu"),
                               window=W, dtype=torch.float32, layers=L)
    assert {k: (t.shape, t.device) for k, t in whole.items()} == {
        k: (t.shape, t.device) for k, t in want.items()}


def test_prefill_logits_match_repro(setup):
    cfg, tcfg, params = setup
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 21))
    toks[1, :3] = 0                                      # left-pad
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 21, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    cache = eng.model.init_cache(2, 21, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(got.numpy(), want, 1e-4)
    assert cache["pos"].device.type == "cpu"
    assert cache["pos"].tolist() == [list(range(5, 21))] * tcfg.num_layers


@pytest.mark.parametrize("decode_mode,bits", [("scan", None),
                                              ("per_token", None),
                                              ("scan", 8), ("scan", 4)])
def test_engine_matches_repro(setup, decode_mode, bits):
    """A left-padded batch whose prompts cover the window, ragged budgets:
    the port's tokens are repro's.  Both serve the planes of one bake of
    repro's (quantized under ``bits``)."""
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
    eng = teng.Engine(tcfg, _model(setup, tree), max_batch=2, max_seq=48,
                      quant=tpol, decode_mode=decode_mode, device="cpu")
    assert _toks(eng.generate(_reqs(teng.Request, specs))) == _toks(want)
    a = tcfg.attention
    ring = 2 * tcfg.num_layers * 2 * 16 * a.num_kv_heads * a.head_dim * 4
    assert eng.stats()["cache_bytes"] == ring + tcfg.num_layers * 16 * 4


def test_short_prompt_and_continuous_engine_refused(setup):
    cfg, tcfg, params = setup
    model = _model(setup)
    eng = teng.Engine(tcfg, model, max_seq=48, device="cpu")
    with pytest.raises(ValueError, match="sliding-window ring buffer"):
        eng.generate(_reqs(teng.Request, [(12, 8)]))
    with pytest.raises(ValueError, match="sliding-window ring buffer"):
        jeng.Engine(cfg, params, max_seq=48).generate(
            _reqs(jeng.Request, [(12, 8)]))
    # one token: the cache, and so the ring, holds the 12 prompt positions
    assert len(eng.generate(_reqs(teng.Request, [(12, 1)]))[0]["tokens"]) == 1
    with pytest.raises(ValueError, match="not continuous-servable"):
        teng.ContinuousEngine(tcfg, model, device="cpu")


def test_launch_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--new-tokens", "3"])
    assert "statuses={'FINISHED_BUDGET': 2}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="use --engine batch"):
        serve.main(["--arch", ARCH, "--engine", "continuous", "--device",
                    "cpu"])
