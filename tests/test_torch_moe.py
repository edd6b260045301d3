"""The port's mixture of experts against ``repro``'s on the same weights and
inputs, then llama4-maverick-400b-a17b (smoke config, alternating dense and
MoE blocks, a shared expert) through both of the port's engines against
``repro``'s.

Weights come from ``repro``'s seeded init, inputs from numpy.  The MoE
output is held at 1e-5 of its scale (float32 sums in another order), and
the routing must choose the same experts.  Expert planes equal ``repro``'s
``spectral_cache`` to 2e-7 of their scale; quantized from the same float planes, their
int8 / int4 codes and scales equal ``repro``'s exactly.  Prefill logits are
held at 1e-4 of their scale and greedy tokens must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CompressionConfig, MoEConfig  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.base import CompressionConfig as TComp  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.configs.registry import get_config as tfull  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import ffn as tffn  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"
D_MODEL, D_FF, E = 64, 128, 4


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------
def _configs(topk, block, capacity):
    kw = dict(num_experts=E, top_k=topk, capacity_factor=capacity,
              shared_expert=True, router_group_size=8)
    ckw = dict(enabled=bool(block), block_ffn=block, block_expert=block)
    return MoEConfig(**kw), CompressionConfig(**ckw), TMoE(**kw), TComp(**ckw)


def _load(m, tree):
    """Copy repro's MoE tree (numpy leaves) into the port's ``MoE``."""
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(np.array(tree["router"])))
        for name in tffn.EXPERT_PROJECTIONS:
            getattr(m.experts, name).copy_(torch.from_numpy(
                np.array(tree["experts"][name])))
            leaf = tree["shared"][name]
            key = "wc" if "wc" in leaf else "w"
            getattr(getattr(m.shared, name), key).copy_(
                torch.from_numpy(np.array(leaf[key])))


def _layer(topk, block, capacity):
    jm, jc, tm, tc = _configs(topk, block, capacity)
    params = jffn.init_moe(jax.random.PRNGKey(3), D_MODEL, D_FF, jm, jc)
    m = tffn.MoE(D_MODEL, D_FF, tm, tc, device=torch.device("cpu"))
    _load(m, jax.tree.map(np.asarray, params))
    return jm, jc, tm, tc, params, m


def _bake_repro(params, gauss=True):
    """repro's serve planes for the expert stacks and the shared expert."""
    ex = dict(params["experts"])
    for name in ("up", "gate", "down"):
        ex[f"{name}_cache"] = jcc.spectral_cache(ex[name], gauss)
    shared = {n: {**p, "wc_cache": jcc.spectral_cache(p["wc"], gauss)}
              for n, p in params["shared"].items()}
    return {**params, "experts": ex, "shared": shared}


def _ref_experts(params, x, jm, g):
    """The experts repro's routing chooses in groups of ``g`` tokens: its
    float32 logits, softmax and top-k, written out with jax (``moe`` does
    not return them)."""
    xt = jnp.asarray(x).reshape(-1, g, x.shape[-1])
    logits = jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), jm.top_k)[1])


@pytest.mark.parametrize("S", [8, 1])
@pytest.mark.parametrize("capacity", [8.0, 0.5])
@pytest.mark.parametrize("block", [16, 0])
@pytest.mark.parametrize("topk", [1, 2])
def test_moe_matches_repro(topk, block, capacity, S):
    """Circulant (block 16, baked planes) and dense experts, top-1 and
    top-2, no drops (capacity 8) and drops (0.5), S > 1 and the dropless
    S == 1 decode: outputs within 1e-5 of their scale, the same experts
    chosen."""
    jm, jc, tm, tc, params, m = _layer(topk, block, capacity)
    if block:
        params = _bake_repro(params)
        m.experts.bake_spectral()
        for lin in (m.shared.up, m.shared.gate, m.shared.down):
            lin.bake_spectral()
    x = np.random.RandomState(5).randn(2, S, D_MODEL).astype(np.float32)
    want, _ = jffn.moe(params, jnp.asarray(x), d_ff=D_FF, moe_cfg=jm,
                       comp=jc, mode="serve")
    with torch.no_grad():
        got = tffn.moe(m, torch.from_numpy(x), d_ff=D_FF, moe_cfg=tm,
                       comp=tc, mode="serve")
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    T = 2 * S
    g = np.gcd(min(tm.router_group_size, T), T)
    cap = min(max(1, int(np.ceil(g * topk / E * capacity))), g)
    if S == 1:
        cap = g
    xt = torch.from_numpy(x).reshape(T // g, g, D_MODEL)
    disp, _, idx, _ = tffn.route(m.router, xt, E, topk, cap)
    np.testing.assert_array_equal(idx.numpy(),
                                  _ref_experts(params, x, jm, g))
    kept = int(disp.sum())
    assert kept == T * topk if (S == 1 or capacity == 8.0) else kept < T * topk


def test_moe_records_the_smallest_router_logit_gap():
    """With ``logit_gap`` set to a tensor, each ``moe`` call folds the
    smallest top-1 / top-2 gap of its router logits into it in place (held
    against the gap of repro's float32 logits; a second call on inputs with
    wider gaps keeps it) and the output does not change; left at None,
    nothing is recorded."""
    jm, _, tm, tc, params, m = _layer(1, 0, 8.0)
    x = np.random.RandomState(6).randn(2, 8, D_MODEL).astype(np.float32)
    with torch.no_grad():
        plain = tffn.moe(m, torch.from_numpy(x), d_ff=D_FF, moe_cfg=tm,
                         comp=tc, mode="serve")
        assert m.logit_gap is None
        gap = torch.full((), float("inf"))
        m.logit_gap = gap
        got = tffn.moe(m, torch.from_numpy(x), d_ff=D_FF, moe_cfg=tm,
                       comp=tc, mode="serve")
        tffn.moe(m, torch.from_numpy(4 * x), d_ff=D_FF, moe_cfg=tm,
                 comp=tc, mode="serve")
    assert torch.equal(got, plain)
    logits = np.einsum("td,de->te", x.reshape(-1, D_MODEL),
                       np.asarray(params["router"], np.float32))
    top = np.sort(logits, axis=-1)
    want = float((top[:, -1] - top[:, -2]).min())
    assert m.logit_gap is gap                  # updated in place
    np.testing.assert_allclose(float(m.logit_gap), want, rtol=1e-5,
                               atol=1e-6)


def test_expert_planes_and_codes_match_repro():
    _, _, _, _, params, m = _layer(1, 16, 8.0)
    m.experts.bake_spectral()
    for name in tffn.EXPERT_PROJECTIONS:
        want = jcc.spectral_cache(params["experts"][name])
        got = m.experts.cache(name)
        assert set(got) == set(want)
        for plane, t in got.items():
            assert tuple(t.shape) == (E, *want[plane].shape[1:])
            ref = np.asarray(want[plane])
            # one or two float32 steps: the DFT products sum in another order
            np.testing.assert_allclose(
                t.numpy(), ref, rtol=0,
                atol=2e-7 * max(1.0, float(np.abs(ref).max())))
        # the same float planes through both codecs: identical codes
        for bits in (8, 4):
            jcodes = jq.quantize_plane_cache(want, bits)
            tcodes = tq.quantize_plane_cache(
                {p: torch.from_numpy(np.array(a)) for p, a in want.items()},
                bits)
            assert set(tcodes) == set(jcodes)
            for key, t in tcodes.items():
                np.testing.assert_array_equal(t.numpy(),
                                              np.asarray(jcodes[key]))
            assert tuple(tcodes["wr_s"].shape) == (E, want["wr"].shape[1], 1)


def test_bc_expert_linear_is_per_expert_bc_linear():
    """The expert helper on the CPU: each expert's rows against its own
    planes, int8 planes with (E, p, 1) scales included."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(3, 4, 2, 16).astype(np.float32) / 6)
    x = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
    for cache in (tcc.spectral_cache(w),
                  tq.quantize_plane_cache(tcc.spectral_cache(w), 8)):
        got = tops.bc_expert_linear(x, cache, 16, 60)
        assert got.shape == (3, 5, 60)
        for e in range(3):
            ce = {n: t[e] for n, t in cache.items()}
            torch.testing.assert_close(
                got[e], tcc.bc_matmul_spectral(x[e], ce, 16, 60),
                rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_grouped_expert_call_matches_repro_vmap(bits):
    """The expert stack as one grouped call (``bc_expert_linear`` ->
    ``bc_fused_matmul`` on the whole stack; on the CPU its plain version
    expert by expert) against ``repro``'s ``jax.vmap`` of
    ``bc_matmul_spectral`` over the experts (``layers/ffn.py:_expert_ffn``),
    at llama4's smoke widths, on float, int8 and int4 planes: within 1e-5
    of the scale."""
    cfg = tget(ARCH)
    k = cfg.compression.block_for("expert")
    n_exp, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    rng = np.random.RandomState(7)
    for n_in, n_out in ((d, f), (f, d)):
        w = (rng.randn(n_exp, -(-n_out // k), -(-n_in // k), k)
             / np.sqrt(n_in)).astype(np.float32)
        x = rng.randn(n_exp, 6, n_in).astype(np.float32)
        jcache = jcc.spectral_cache(jnp.asarray(w))
        if bits is not None:
            jcache = jq.quantize_plane_cache(jcache, bits)
        want = np.asarray(jax.vmap(
            lambda c, xe: jcc.bc_matmul_spectral(xe, c, k, n_out))(
                jcache, jnp.asarray(x)))
        tcache = {n: torch.from_numpy(np.array(t)) for n, t in jcache.items()}
        got = tops.bc_expert_linear(torch.from_numpy(x), tcache, k, n_out)
        assert got.shape == (n_exp, 6, n_out)
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# llama4 (smoke) through the model and both engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _model(setup, tree=None):
    cfg, tcfg, params = setup
    return from_jax_params(jax.tree.map(np.asarray, params if tree is None
                                        else tree), tcfg, device="cpu")


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def _toks(results):
    return [r["tokens"] for r in results]


def test_llama4_blocks_and_carry_over(setup):
    cfg, tcfg, params = setup
    model = _model(setup)
    kinds = ["moe" if hasattr(b, "moe") else "attn" for b in model.blocks]
    assert kinds == ["attn", "moe"] * (cfg.num_layers // 2)
    tree = jax.tree.map(np.asarray, params)
    seg = tree["segments"][0]             # pattern (attn, moe), stacked
    for i, block in enumerate(model.blocks[1::2]):
        moe = seg[1]["moe"]
        np.testing.assert_array_equal(block.moe.router.numpy(),
                                      moe["router"][i])
        for name in tffn.EXPERT_PROJECTIONS:
            np.testing.assert_array_equal(
                getattr(block.moe.experts, name).numpy(),
                moe["experts"][name][i])
            np.testing.assert_array_equal(
                getattr(block.moe.shared, name).wc.numpy(),
                moe["shared"][name]["wc"][i])
    baked = jbake(params, cfg)
    carried = _model(setup, baked)
    ex = carried.blocks[1].moe.experts
    jex = baked["segments"][0][1]["moe"]["experts"]
    for name in tffn.EXPERT_PROJECTIONS:
        for plane, t in ex.cache(name).items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jex[f"{name}_cache"][plane][0]))


def test_llama4_prefill_logits_match_repro(setup):
    cfg, tcfg, params = setup
    toks = np.random.RandomState(4).randint(1, 500, size=(2, 13))
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), {"tokens": jnp.asarray(toks, jnp.int32)},
        build_model(cfg).init_cache(2, 13, dtype=jnp.float32))
    eng = teng.Engine(tcfg, _model(setup), device="cpu")
    cache = eng.model.init_cache(2, 13, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, _ = tdec.make_prefill_step(
            tcfg, kernel_fn=tops.spectral_contract)(
            eng.params, {"tokens": torch.from_numpy(toks)}, cache)
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_llama4_both_engines_match_repro(setup):
    """The batch engine (two buckets, ragged budgets, left pads routed
    with the prompt) and the continuous engine (slots recycled) against
    repro's; each request alone through the batch engine equals the
    continuous engine."""
    cfg, tcfg, params = setup
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
    # page-aligned prompts: both engines route the same tokens
    aligned = [(16, 6), (8, 5)]
    oracle = teng.Engine(tcfg, model, max_batch=1, max_seq=32, device="cpu")
    cont = teng.ContinuousEngine(tcfg, model, device="cpu", **kw)
    assert (_toks(oracle.generate(_reqs(teng.Request, aligned)))
            == _toks(cont.generate(_reqs(teng.Request, aligned))))


@pytest.mark.parametrize("bits", [8, 4])
def test_llama4_quantized_experts_int8_pool_match_repro(setup, bits):
    """int8 / int4 planes (expert stacks included, carried from repro so
    both sides serve identical codes) with an int8 pool."""
    cfg, tcfg, params = setup
    jpol = jq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    tpol = tq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    kw = dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=4)
    specs = [(15, 8), (9, 6), (12, 7)]
    want = jeng.ContinuousEngine(cfg, params, quant=jpol, **kw).generate(
        _reqs(jeng.Request, specs))
    qtree = jbake(params, cfg, jpol)
    model = _model(setup, qtree)
    ex = model.blocks[1].moe.experts
    assert ex.up_cache_wr.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert tuple(ex.up_cache_wr_s.shape) == (
        E, ex.up_cache_wr.shape[1], 1)
    got = teng.ContinuousEngine(tcfg, model, device="cpu", quant=tpol,
                                **kw).generate(_reqs(teng.Request, specs))
    assert _toks(got) == _toks(want)
    # the clip census covers the expert stacks: one plane each per layer
    rep, jrep = tq.plane_clip_report(model), jq.plane_clip_report(qtree)
    assert rep["clipped"] == jrep["clipped"] and rep["total"] == jrep["total"]


def test_llama4_port_bakes_and_quantizes_expert_stacks(setup):
    """The port's own bake: every expert stack gets (E, p, q, kf) planes,
    then int8 codes with (E, p, 1) scales in place."""
    _, tcfg, _ = setup
    model = tbake(_model(setup), tcfg, tq.QuantPolicy(quant_weights=True))
    caches = [(p, pre) for p, _, pre, _ in tq.baked_caches(model)
              if pre != "wc_cache"]
    assert len(caches) == 3 * (tcfg.num_layers // 2)
    ex = model.blocks[1].moe.experts
    assert ex.down_cache_wr.dtype == torch.int8
    assert tuple(ex.down_cache_ws1_s.shape) == (E, ex.down.shape[1], 1)


def test_launch_cli_llama4_on_cpu(capsys):
    from repro_torch.launch import serve
    for engine in ("batch", "continuous"):
        serve.main(["--arch", ARCH, "--engine", engine, "--device", "cpu",
                    "--requests", "2", "--new-tokens", "3"])
        assert "statuses={'FINISHED_BUDGET': 2}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b", "gemma2-9b"])
def test_config_copies_equal_repro(arch):
    """The port's own copies of the archs' configs, published and smoke,
    carry repro's values field for field.  ``sandwich_norm`` is the
    port's one field more: set where repro's model adds the post-norms
    by name, a gemma2."""
    for want, got in ((get_config(arch), tfull(arch)),
                      (get_smoke_config(arch), tget(arch))):
        got = dataclasses.asdict(got)
        assert got.pop("sandwich_norm") == want.name.startswith("gemma2")
        assert got == dataclasses.asdict(want)
