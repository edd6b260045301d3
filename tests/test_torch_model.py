"""The port's tinyllama (smoke config) against ``repro``'s on the same
weights: the weight carry-over, the baked spectral planes, rmsnorm / RoPE /
attention block / MLP, prefill logits, and paged decode logits.

``repro``'s parameters come from its own seeded init and reach the port
through ``from_jax_params`` as numpy arrays.  Float32 comparisons allow
1e-4 absolute: measured differences are ~3e-6 on logits of scale ~4 (sums
in another order).  The bf16 comparison allows 2^-5 of the logit scale:
bf16 activations round at other points in the two frameworks (measured
~0.04 on logits of scale 4, a bf16 step there being 2^-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import embeddings as jemb  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import embeddings as temb  # noqa: E402
from repro_torch.layers import ffn as tffn  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.serve.params import precompute_serving_params as tbake  # noqa: E402

ARCH = "tinyllama-1.1b"
ATOL = 1e-4
PROJ = {"attn": ("q", "k", "v", "o"), "mlp": ("up", "gate", "down")}


def _setup(dtype):
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    tcfg = tget(ARCH).replace(dtype=dtype)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(tree, tcfg, device="cpu")
    return cfg, tcfg, params, tree, model


@pytest.fixture(scope="module")
def f32():
    cfg, tcfg, params, tree, model = _setup("float32")
    return cfg, tcfg, params, jbake(params, cfg), tree, tbake(model, tcfg)


def test_from_jax_params_round_trip_and_planes(f32):
    cfg, tcfg, _, baked, tree, model = f32
    np.testing.assert_array_equal(model.embed.table.numpy(),
                                  tree["embed"]["table"])
    seg = tree["segments"][0][0]
    jseg = baked["segments"][0][0]
    assert len(model.blocks) == cfg.num_layers
    for i, block in enumerate(model.blocks):
        for ln in ("ln1", "ln2"):
            np.testing.assert_array_equal(getattr(block, ln).scale.numpy(),
                                          seg[ln]["scale"][i])
        for part, names in PROJ.items():
            for name in names:
                lin = getattr(getattr(block, part), name)
                np.testing.assert_array_equal(lin.wc.numpy(),
                                              seg[part][name]["wc"][i])
                planes = jseg[part][name]["wc_cache"]
                for plane, t in lin.wc_cache.items():
                    np.testing.assert_allclose(
                        t.numpy(), np.asarray(planes[plane][i]), rtol=0,
                        atol=1e-6)


def test_rmsnorm_and_rope_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 32).astype(np.float32)
    scale = (0.1 * rng.randn(32)).astype(np.float32)
    ref = np.asarray(jnorms.rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x)))
    got = tnorms.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    pos = rng.randint(0, 300, size=(2, 5)).astype(np.int32)
    ref = np.asarray(jemb.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = temb.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    # angles up to 300 rad: cos/sin of float32 arguments differ by ulps
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_attention_block_and_mlp_match(f32):
    cfg, tcfg, _, baked, _, model = f32
    layer0 = jax.tree.map(lambda a: a[0], baked["segments"][0][0])
    rng = np.random.RandomState(1)
    S = 12
    x = rng.randn(1, S, cfg.d_model).astype(np.float32)
    cache = jattn.init_kv_cache(1, S, cfg, dtype=jnp.float32)
    ref, ref_cache = jattn.attention_block(
        layer0["attn"], jnp.asarray(x), cfg=cfg, cache=cache, cache_pos=0,
        mode="serve")
    tcache = tattn.init_kv_cache(1, S, tcfg, device="cpu",
                                 dtype=torch.float32)
    got, tcache = tattn.attention_block(
        model.blocks[0].attn, torch.from_numpy(x), cfg=tcfg, cache=tcache,
        cache_pos=0, mode="serve")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(ref_cache[key]), rtol=0,
                                   atol=ATOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    ref = jffn.mlp(layer0["mlp"], jnp.asarray(x), d_ff=cfg.d_ff,
                   comp=cfg.compression, mode="serve")
    got = tffn.mlp(model.blocks[0].mlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _prefill_then_decode(cfg, tcfg, baked, model):
    """Prefill one 12-token prompt into pages of 4, then one paged decode
    step for two slots (slot 1 idle) in both packages."""
    rng = np.random.RandomState(2)
    S, page, P = 12, 4, 8
    toks = rng.randint(1, 500, size=(1, S)).astype(np.int32)
    jm, tm = build_model(cfg), tbuild(tcfg)
    jl, jd = jm.prefill(baked, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(1, S, dtype=jnp.float32))
    tl, td = tm.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                        tm.init_cache(1, S, dtype=torch.float32,
                                      device="cpu"))
    pages = np.array([3, 5, 1], np.int32)
    jpool = jkv.pack_prefill_cache(jkv.build_pool(cfg, P, page), jd,
                                   jnp.asarray(pages), page)
    tpool = tkv.pack_prefill_cache(tkv.build_pool(tcfg, P, page,
                                                  device="cpu"),
                                   td, torch.from_numpy(pages), page)
    table = np.zeros((2, 4), np.int32)
    table[0, :3] = pages
    pos = np.array([S, -1], np.int32)
    cur = np.array([[7], [9]], np.int32)
    jlg, _ = jm.decode_step(baked, jnp.asarray(cur), jpool, jnp.asarray(pos),
                            block_table=jnp.asarray(table))
    tlg, _ = tm.decode_step(model, torch.from_numpy(cur).long(), tpool,
                            torch.from_numpy(pos),
                            block_table=torch.from_numpy(table))
    return (np.asarray(jl.astype(jnp.float32)), tl.float().numpy(),
            np.asarray(jlg.astype(jnp.float32)), tlg.float().numpy())


def test_prefill_and_paged_decode_logits_f32(f32):
    cfg, tcfg, _, baked, _, model = f32
    jl, tl, jlg, tlg = _prefill_then_decode(cfg, tcfg, baked, model)
    assert tl.shape == jl.shape and tlg.shape == jlg.shape == (2, 1, 512)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tlg, jlg, rtol=0, atol=ATOL)


def test_prefill_and_paged_decode_logits_bf16():
    cfg, tcfg, params, _, model = _setup("bfloat16")
    jl, tl, jlg, tlg = _prefill_then_decode(cfg, tcfg, jbake(params, cfg),
                                            tbake(model, tcfg))
    for got, ref in ((tl, jl), (tlg, jlg)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2.0 ** -5 * np.abs(ref).max())
