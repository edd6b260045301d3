"""Projection fusion (``CompressionConfig.fuse_projections``) in the port
against ``repro``, on the CPU, with numpy inputs from a seed.

* ``fused_spectral_cache``: planes within 1e-6 of their scale (float32 DFT
  products summed in another order).
* int8 / int4 fused planes: the same float planes through both codecs give
  identical codes, and scales within 1e-7 relative; one scale per block
  row over Σp_i.
* ``bc_matmul_fused`` at GQA shapes (unequal p_i) on all three plane lanes
  and through the spectral-MAC hook: within 1e-5 of the output's scale.
* ``precompute_serving_params`` with fusion: fused caches, no q/k/v/up/gate
  planes, idempotent, the same plane bytes as without fusion;
  ``from_jax_params`` carries ``repro``'s fused caches in their own dtype.
* Both engines on the smoke configs of the five paged-servable archs
  (tinyllama, qwen2.5 with its QKV bias, qwen3 with qk-norm, phi-3-vision,
  llama4 with its shared expert), fused: prefill logits within 1e-4 of
  their scale and greedy tokens identical to ``repro``'s, in float32 and on
  int8 / int4 planes with an int8 pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core import circulant as jcc  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import decode as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.core import circulant as tcc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import ffn as tffn  # noqa: E402
from repro_torch.layers.attention import Attention  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import decode as tdec  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402

ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b", "phi-3-vision-4.2b",
         "llama4-maverick-400b-a17b")
K = 16
# GQA: q (4 blocks of 16 = 2 heads of 32), k and v (1 block each)
PS, Q = (4, 1, 1), 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _gens(seed=0, ps=PS):
    rng = np.random.RandomState(seed)
    return [(rng.randn(p, Q, K) / np.sqrt(Q * K)).astype(np.float32)
            for p in ps]


def _fused_cfgs(arch):
    cfg = get_smoke_config(arch).replace(dtype="float32").with_compression(
        fuse_projections=True)
    tcfg = tget(arch).replace(dtype="float32").with_compression(
        fuse_projections=True)
    return cfg, tcfg


# ---------------------------------------------------------------------------
# the fused planes and the fused call
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gauss", [True, False])
def test_fused_spectral_cache_matches_repro(gauss):
    ws = _gens()
    want = jcc.fused_spectral_cache([jnp.asarray(w) for w in ws], gauss)
    got = tcc.fused_spectral_cache([_t(w) for w in ws], gauss)
    assert set(got) == set(want)
    for name, t in got.items():
        ref = np.asarray(want[name])
        assert tuple(t.shape) == (sum(PS), Q, K // 2 + 1)
        np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(ref).max()))
    # FFT then concatenate: each projection's own planes, stacked
    parts = [tcc.spectral_cache(_t(w), gauss) for w in ws]
    for name, t in got.items():
        torch.testing.assert_close(
            t, torch.cat([p[name] for p in parts]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_quantized_planes_match_repro(bits):
    want_f = jcc.fused_spectral_cache([jnp.asarray(w) for w in _gens()])
    want = jq.quantize_plane_cache(want_f, bits)
    got = tq.quantize_plane_cache({n: _t(a) for n, a in want_f.items()},
                                  bits)
    assert set(got) == set(want)
    for name, t in got.items():
        ref = np.asarray(want[name])
        if name.endswith("_s"):
            assert tuple(t.shape) == (sum(PS), 1)    # per block row, Σp_i
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-7, atol=0)
        else:
            assert t.dtype == (torch.int8 if bits == 8 else torch.uint8)
            np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("lane", ["float32", "hook", "int8", "int4"])
def test_bc_matmul_fused_matches_repro(lane):
    """Unequal p_i (GQA), n_outs shorter than p_i·k for the last two."""
    ws = _gens(1)
    n_outs = [4 * K, K - 3, K - 5]
    x = np.random.RandomState(2).randn(2, 5, Q * K - 7).astype(np.float32)
    jcache = jcc.fused_spectral_cache([jnp.asarray(w) for w in ws])
    if lane in ("int8", "int4"):
        jcache = jq.quantize_plane_cache(jcache, int(lane[-1]))
    want = jcc.bc_matmul_fused(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                               n_outs, "serve", cache=jcache)
    hook = tops.spectral_contract if lane == "hook" else None
    got = tcc.bc_matmul_fused(_t(x), [_t(w) for w in ws], n_outs, "serve",
                              cache={n: _t(a) for n, a in jcache.items()},
                              kernel_fn=hook)
    assert len(got) == 3
    for g, w, n in zip(got, want, n_outs):
        w = np.asarray(w)
        assert tuple(g.shape) == (2, 5, n)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    # without a cache the planes are derived on the fly
    if lane == "float32":
        again = tcc.bc_matmul_fused(_t(x), [_t(w) for w in ws], n_outs)
        for a, g in zip(again, got):
            torch.testing.assert_close(a, g, rtol=0, atol=1e-5)


def test_bc_matmul_fused_training_raises():
    """Fused training is ported (it raised before): train mode concatenates
    the generators and runs ``bc_matmul_fft``, the same values as the
    fused serve path (1e-5 of the scale), with the gradient reaching every
    generator through ``torch.cat``."""
    ws = [_t(w).requires_grad_() for w in _gens()]
    x = torch.randn(3, Q * K, generator=torch.Generator().manual_seed(0))
    got = tcc.bc_matmul_fused(x, ws, [K, K, K], "train")
    ref = tcc.bc_matmul_fused(x, [w.detach() for w in ws], [K, K, K])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.detach(), r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    sum(g.sum() for g in got).backward()
    assert all(w.grad is not None and w.grad.abs().max() > 0 for w in ws)


# ---------------------------------------------------------------------------
# baking, quantizing and carrying the fused planes
# ---------------------------------------------------------------------------
def _plane_bytes(model):
    return sum(t.numel() * t.element_size()
               for _, _, _, cache in tq.baked_caches(model)
               for t in cache.values())


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_precompute_bakes_fused_planes_only(bits):
    """llama4's smoke config: every attention block fuses q/k/v, every
    gated MLP (dense layers and the MoE's shared expert) fuses up/gate and
    the expert stacks keep their own planes; the fused projections keep
    none.  Idempotent; the plane bytes equal the unfused bake's."""
    arch = "llama4-maverick-400b-a17b"
    cfg, tcfg = _fused_cfgs(arch)
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(0)))
    policy = tq.QuantPolicy(quant_weights=bits is not None,
                            weight_bits=bits or 8)
    model = tbake(from_jax_params(params, tcfg, device="cpu"), tcfg, policy)
    plain = tbake(from_jax_params(params, tget(arch).replace(
        dtype="float32"), device="cpu"), tget(arch), policy)
    prefixes = {}
    for path, m, prefix, cache in tq.baked_caches(model):
        prefixes.setdefault(prefix, []).append(path)
        if prefix in ("qkv_cache", "upgate_cache"):
            assert cache["wr"].dtype == (torch.float32 if bits is None else
                                         torch.int8 if bits == 8 else
                                         torch.uint8)
            p = sum(lin.wc.shape[0] for lin in m.fused_linears())
            assert cache["wr"].shape[0] == p
            if bits is not None:
                assert tuple(cache["wr_s"].shape) == (p, 1)
    L = tcfg.num_layers
    assert len(prefixes["qkv_cache"]) == L
    assert len(prefixes["upgate_cache"]) == L            # dense + shared
    assert len(prefixes["up_cache"]) == L // 2           # expert stacks
    assert len(prefixes["wc_cache"]) == 2 * L            # o and down
    for name, m in model.named_modules():
        if isinstance(m, (Attention, tffn.MLP)):
            assert all(lin.wc_cache is None for lin in m.fused_linears())
    before = {n: t for n, t in model.named_buffers()}
    assert tbake(model, tcfg, policy) is model
    assert all(t is before[n] for n, t in model.named_buffers())
    assert _plane_bytes(model) == _plane_bytes(plain)
    if bits is not None:                 # 4 planes a cache (Gauss planes)
        rep = tq.plane_clip_report(model)
        assert rep["planes"] == 4 * sum(map(len, prefixes.values()))
        assert rep["total"] == tq.plane_clip_report(plain)["total"]


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_from_jax_params_carries_fused_planes(bits):
    arch = "qwen2.5-3b"
    cfg, tcfg = _fused_cfgs(arch)
    params = build_model(cfg).init(jax.random.PRNGKey(1))
    policy = (None if bits is None
              else jq.QuantPolicy(quant_weights=True, weight_bits=bits))
    tree = jbake(params, cfg, policy)
    attn = tree["segments"][0][0]["attn"]
    assert "qkv_cache" in attn and "wc_cache" not in attn["q"]
    model = from_jax_params(jax.tree.map(np.asarray, tree), tcfg,
                            device="cpu")
    for i, block in enumerate(model.blocks):
        for mod, want in ((block.attn, attn["qkv_cache"]),
                          (block.mlp, tree["segments"][0][0]["mlp"][
                              "upgate_cache"])):
            got = mod.fused_cache
            assert set(got) == set(want)
            for name, t in got.items():
                np.testing.assert_array_equal(t.numpy(),
                                              np.asarray(want[name][i]))
    tpol = tq.QuantPolicy(quant_weights=bits is not None,
                          weight_bits=bits or 8)
    carried = {n: t for n, t in model.named_buffers()}
    tbake(model, tcfg, tpol)
    assert all(t is carried[n] for n, t in model.named_buffers()
               if n in carried)
    assert all(lin.wc_cache is None for b in model.blocks
               for lin in b.attn.fused_linears())


# ---------------------------------------------------------------------------
# the five archs through both engines, fused
# ---------------------------------------------------------------------------
SPECS = [(18, 7), (9, 6), (14, 5)]


def _reqs(cls, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(SPECS)]


def _toks(results):
    return [r["tokens"] for r in results]


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_logits_match_repro(arch):
    cfg, tcfg = _fused_cfgs(arch)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 500, size=(2, 13))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    length = 13
    if cfg.frontend == "vision_stub":
        patches = rng.randn(2, cfg.num_patches, cfg.d_model).astype(
            np.float32)
        batch["patches"], tbatch["patches"] = (jnp.asarray(patches),
                                               torch.from_numpy(patches))
        length = max(length, cfg.num_patches)
    want, _ = jdec.make_prefill_step(cfg)(
        jbake(params, cfg), batch,
        build_model(cfg).init_cache(2, length, dtype=jnp.float32))
    eng = teng.Engine(tcfg, from_jax_params(jax.tree.map(np.asarray, params),
                                            tcfg, device="cpu"),
                      device="cpu")
    assert eng.params.blocks[0].attn.fused_cache is not None
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    for hook in (None, tops.spectral_contract):
        cache = eng.model.init_cache(2, length, dtype=torch.float32,
                                     device="cpu")
        with torch.no_grad():
            got, _ = tdec.make_prefill_step(tcfg, kernel_fn=hook)(
                eng.params, tbatch, cache)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_engines_match_repro(arch, bits):
    """The batch engine and the continuous engine (float32 pool; with
    quantized planes an int8 pool), fused, against repro's."""
    cfg, tcfg = _fused_cfgs(arch)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    jpol = tpol = None
    tree = params
    if bits is not None:
        jpol = jq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
        tpol = tq.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
        tree = jbake(params, cfg, jpol)      # identical codes on both sides
    model = from_jax_params(jax.tree.map(np.asarray, tree), tcfg,
                            device="cpu")
    want = jeng.Engine(cfg, params, max_batch=2, max_seq=48,
                       quant=jpol).generate(_reqs(jeng.Request))
    got = teng.Engine(tcfg, model, max_batch=2, max_seq=48, quant=tpol,
                      device="cpu").generate(_reqs(teng.Request))
    assert _toks(got) == _toks(want)
    kw = dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=4)
    cwant = jeng.ContinuousEngine(cfg, params, quant=jpol, **kw).generate(
        _reqs(jeng.Request))
    cgot = teng.ContinuousEngine(tcfg, model, quant=tpol, device="cpu",
                                 **kw).generate(_reqs(teng.Request))
    assert _toks(cgot) == _toks(cwant)
    assert all(lin.wc_cache is None for b in model.blocks
               for lin in b.attn.fused_linears())
