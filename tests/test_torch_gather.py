"""The gather oracle of paged decode against ``repro``'s: the plain version
of the ``paged_gather`` kernel against ``repro``'s Pallas gather in
interpret mode (f32, bf16 and int8 pools, exactly), the masked attention
over the gathered view against ``repro``'s ``chunked_attention`` and the
port's own streamed path, and ``ContinuousEngine(paged_attn="gather")``
against ``repro``'s on f32 and int8 pools (smoke tinyllama, float32
activations).

Attention outputs are held to 1e-5 of their scale (float32 sums in another
order); tokens must be identical, as in ``test_torch_serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.kernels import paged as jpaged  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.quant import codec as jq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.params import precompute_serving_params as jbake  # noqa: E402
from repro_torch.configs.registry import get_smoke_config as tget  # noqa: E402
from repro_torch.kernels import paged as tpaged  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.quant import codec as tq  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

ARCH = "tinyllama-1.1b"


def _pool_case(seed=0, P=11, page=4, H=2, D=16, B=3, maxp=3):
    rng = np.random.RandomState(seed)
    pool = rng.randn(P, page, H, D).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * maxp].reshape(B, maxp)
    table[1, 2] = 0                             # an unowned (trash) entry
    return pool, table.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_gather_matches_pallas_interpret(dtype):
    pool, table = _pool_case()
    if dtype == "int8":
        pool = np.clip(np.round(pool * 40), -127, 127).astype(np.int8)
    jpool = jnp.asarray(pool).astype(dtype)
    want = np.asarray(jpaged.paged_gather_kernel(jpool, jnp.asarray(table),
                                                 interpret=True)
                      .astype(jnp.float32))
    tpool = torch.from_numpy(np.array(jpool.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = tpaged.KERNEL.launches
    got = tpaged.paged_gather(tpool, torch.from_numpy(table))
    assert tpaged.KERNEL.launches == before      # the plain version ran
    assert got.dtype == tpool.dtype and got.shape == (3, 12, 2, 16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("quant", [False, True])
def test_gathered_attention_matches_chunked_and_stream(quant):
    pool_k, table = _pool_case(1)
    pool_v, _ = _pool_case(2)
    B, maxp = table.shape
    page = pool_k.shape[1]
    positions = np.array([9, -1, 5], np.int32)  # partial page, idle, early
    rng = np.random.RandomState(3)
    q = rng.randn(B, 1, 8, 16).astype(np.float32)
    tk, tv = torch.from_numpy(pool_k), torch.from_numpy(pool_v)
    ks = vs = None
    if quant:
        tk, ks = tq.quantize_page_block(tk)
        tv, vs = tq.quantize_page_block(tv)
    ttab, tpos = torch.from_numpy(table), torch.from_numpy(positions)
    kg, vg = tpaged.paged_gather(tk, ttab), tpaged.paged_gather(tv, ttab)
    if quant:
        rep = lambda s: s[ttab.long()].repeat_interleave(  # noqa: E731
            page, dim=1)[..., None]
        kg, vg = kg.float() * rep(ks), vg.float() * rep(vs)
    idx = torch.arange(maxp * page)[None, :]
    kvpos = torch.where(idx <= tpos[:, None], idx, torch.full_like(idx, -1))
    rows = tpos.clamp(min=0)[:, None].long()
    got = tattn.masked_attention(torch.from_numpy(q), kg, vg, rows, kvpos,
                                 softcap=3.0)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(kg.numpy()), jnp.asarray(vg.numpy()),
        softcap=3.0, q_pos0=jnp.asarray(rows[:, 0].numpy()),
        kv_positions=jnp.asarray(kvpos.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got[1] == 0).all()                  # the idle slot
    stream = tpa.paged_attention_stream(torch.from_numpy(q[:, 0]), tk, tv,
                                        ttab, tpos, softcap=3.0, k_scale=ks,
                                        v_scale=vs)
    np.testing.assert_allclose(got[:, 0].numpy(), stream.numpy(), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the engine's gather path against repro's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    tcfg = tget(ARCH).replace(dtype="float32")
    return cfg, tcfg, build_model(cfg).init(jax.random.PRNGKey(0))


def _reqs(cls, specs, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_engine_gather_matches_repro(setup, kv):
    """Slot recycling under the halved default budget of the gather path;
    the int8 pool runs with int8 planes, identical on both sides."""
    cfg, tcfg, params = setup
    quant = kv == "int8"
    jpol = jq.QuantPolicy(kv, quant_weights=quant)
    tpol = tq.QuantPolicy(kv, quant_weights=quant)
    specs = [(20, 13), (12, 9), (16, 11), (9, 10)]
    kw = dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=5,
              paged_attn="gather")
    jeng_ = jeng.ContinuousEngine(cfg, params, quant=jpol, **kw)
    want = jeng_.generate(_reqs(jeng.Request, specs))
    model = from_jax_params(jax.tree.map(np.asarray,
                                         jbake(params, cfg, jpol)),
                            tcfg, device="cpu")
    eng = teng.ContinuousEngine(tcfg, model, device="cpu", quant=tpol, **kw)
    got = eng.generate(_reqs(teng.Request, specs))
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["status"] for g in got] == ["FINISHED_BUDGET"] * 4
    st, jst = eng.stats(), jeng_.stats()
    assert st["attention_impl"] == "gather"
    assert eng.scheduler.max_tokens_in_flight == 33   # halved default
    for key in ("kv_pool_bytes", "quant_policy", "attention_impl",
                "attention_bytes_per_token", "peak_attention_bytes",
                "decode_peak_bytes_est"):
        assert st[key] == jst[key], key
