"""xlstm-125m (smoke config: (mlstm, mlstm, slstm) x 2, block-circulant
cell projections) in the port against ``repro`` on the same weights and
inputs.

Weights come from ``repro``'s seeded init (carried by
``from_jax_params``), inputs from numpy, float32 throughout.  The cells
alone: the mLSTM over three chunks (a chunk of 4 passed in), then decode
steps carrying its state, and the sLSTM's scan then steps; outputs and
every state leaf within 1e-5 of their scale.  Then prefill logits within
1e-4 of their scale, greedy tokens equal to ``repro``'s ``Engine`` under
both decode modes and on float32, int8 and int4 planes, the continuous
engine's refusal, and the launcher.
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
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "xlstm-125m"


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


@pytest.mark.parametrize("kind,block", [("mlstm", 0), ("slstm", 2)])
def test_cell_matches_repro_then_carries_its_state(setup, kind, block):
    """A 12-position prefill (the mLSTM in three chunks of 4) from the
    initial state, then 3 one-position steps carrying it."""
    cfg, tcfg, params = setup
    r = cfg.recurrent
    jp = jax.tree.map(lambda a: a[0], params["segments"][0][block]["cell"])
    cell = _model(setup).blocks[block].cell
    B, S, steps = 2, 12, 3
    xs = np.random.RandomState(block).randn(B, S + steps, cfg.d_model)
    xs = xs.astype(np.float32)
    if kind == "mlstm":
        dh = int(cfg.d_model * r.proj_factor) // r.mlstm_heads
        jstate = jrec.init_mlstm_state(B, r.mlstm_heads, dh)
        tstate = trec.init_mlstm_state(B, r.mlstm_heads, dh,
                                       device=torch.device("cpu"))
        jfn = jax.jit(lambda x, st: jrec.mlstm_block(
            jp, x, heads=r.mlstm_heads, proj_factor=r.proj_factor,
            comp=cfg.compression, mode="serve", state=st, chunk=4))

        def tfn(x, st):
            return trec.mlstm_block(cell, x, heads=r.mlstm_heads, state=st,
                                    chunk=4)
    else:
        jstate = jrec.init_slstm_state(B, cfg.d_model)
        tstate = trec.init_slstm_state(B, cfg.d_model,
                                       device=torch.device("cpu"))
        jfn = jax.jit(lambda x, st: jrec.slstm_block(
            jp, x, comp=cfg.compression, mode="serve", state=st))

        def tfn(x, st):
            return trec.slstm_block(cell, x, state=st)
    for lo, hi in [(0, S)] + [(p, p + 1) for p in range(S, S + steps)]:
        want, jstate = jfn(jnp.asarray(xs[:, lo:hi]), jstate)
        with torch.no_grad():
            got, tstate = tfn(torch.from_numpy(xs[:, lo:hi]), tstate)
        _close(got.numpy(), want, 1e-5)
        assert len(tstate) == len(jstate)
        for t, j in zip(tstate, jstate):
            _close(t.numpy(), j, 1e-5)


def test_mlstm_chunks_must_tile_the_prompt(setup):
    with pytest.raises(ValueError, match="chunks of 4"):
        trec.mlstm_seq(*(torch.zeros(1, 1, 6, 4),) * 3,
                       torch.zeros(1, 1, 6), torch.zeros(1, 1, 6), chunk=4)


def test_prefill_logits_match_repro(setup):
    cfg, tcfg, params = setup
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 13))
    toks[1, :4] = 0                                      # left-pad
    want, jcache = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 13, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    cache = eng.model.init_cache(2, 13, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, cache = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(got.numpy(), want, 1e-4)
    # the per-layer states against repro's per-segment stacks
    assert len(cache) == tcfg.num_layers
    for i, state in enumerate(cache):
        g, bi = divmod(i, 3)
        for t, j in zip(state, jcache[0][bi]):
            _close(t.numpy(), np.asarray(j)[g], 1e-4)


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
    r, d = tcfg.recurrent, tcfg.d_model
    dh = int(d * r.proj_factor) // r.mlstm_heads
    mlstm = 2 * 4 * r.mlstm_heads * (dh * dh + dh + 1)
    slstm = 2 * 4 * 4 * d
    assert eng.stats()["cache_bytes"] == 4 * mlstm + 2 * slstm


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
