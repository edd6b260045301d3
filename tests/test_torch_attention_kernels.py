"""The plain versions of the port's two attention kernels against ``repro``:
prefill flash attention against the Pallas kernel in interpret mode and
``attention_ref``; paged flash-decode against the Pallas kernel in
interpret mode and ``paged_attention_stream``.

Inputs are drawn with numpy from a seed.  Float32: both sides compute the
same softmax with sums in another order, so outputs (of scale ~1) agree to
~1e-6; the tolerance is 1e-5 absolute.  Fully masked rows and idle decode
slots must be exactly zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

ATOL = 1e-5

FLASH_CASES = {  # B, Hq, Hkv, Sq, Skv, D, options
    "causal_mha": (1, 4, 4, 16, 16, 32, dict()),
    "causal_gqa": (2, 8, 2, 24, 24, 16, dict()),
    "softcap": (1, 4, 2, 16, 16, 32, dict(softcap=5.0)),
    "window": (1, 4, 2, 40, 40, 16, dict(window=8)),
    "kv_offset": (1, 4, 2, 8, 24, 16, dict(kv_offset=16)),
    "ragged_sq": (1, 2, 1, 37, 37, 16, dict()),
    "not_causal": (1, 2, 2, 12, 20, 16, dict(causal=False)),
    "masked_rows": (1, 2, 2, 8, 8, 16, dict(kv_offset=-4)),
    # head dims the card runs in a padded tile (80 in the bf16 lane's 96,
    # 192 in the 256 tile of the float32 prefill and the bf16 lane)
    "d80_causal_gqa": (1, 8, 2, 24, 24, 80, dict()),
    "d80_window_softcap": (1, 4, 2, 40, 40, 80,
                           dict(window=12, softcap=5.0)),
    "d192_causal_gqa": (1, 8, 2, 24, 24, 192, dict()),
    "d192_window_softcap": (1, 4, 2, 40, 40, 192,
                            dict(window=12, softcap=5.0)),
}


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_and_ref(name):
    B, Hq, Hkv, Sq, Skv, D, opts = FLASH_CASES[name]
    rng = np.random.RandomState(0)
    q, k, v = _rand(rng, B, Hq, Sq, D), _rand(rng, B, Hkv, Skv, D), \
        _rand(rng, B, Hkv, Skv, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jfa.flash_attention(
        jq, jk, jv, block_q=32, block_k=32, interpret=True, **opts))
    ref = np.asarray(jref.attention_ref(jq, jk, jv, **opts))
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), **opts)
    assert got.shape == (B, Hq, Sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    if name == "masked_rows":               # rows 0..3 see no key at all
        assert (got[:, :, :4] == 0).all()


def test_flash_bf16_plain_matches_ref():
    rng = np.random.RandomState(1)
    q, k, v = _rand(rng, 1, 4, 16, 32), _rand(rng, 1, 2, 16, 32), \
        _rand(rng, 1, 2, 16, 32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jref.attention_ref(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (jq, jk, jv))
    got = tfa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    # float32 inside, one rounding to bf16 on each side: one bf16 step
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


def _paged_inputs(G, seed=0, Hkv=2, D=16):
    """4 slots over a pool of 4-position pages: a partial last page, an
    idle slot, a page-aligned end, and a slot using every table entry."""
    rng = np.random.RandomState(seed)
    page, maxp, B = 4, 5, 4
    P = B * maxp + 1
    pool_k, pool_v = _rand(rng, P, page, Hkv, D), _rand(rng, P, page, Hkv, D)
    table = (rng.permutation(P - 1)[:B * maxp] + 1).reshape(B, maxp)
    table = table.astype(np.int32)
    positions = np.array([9, -1, 11, 19], np.int32)
    table[1] = 0                            # the idle slot owns no page
    q = _rand(rng, B, Hkv * G, D)
    return q, pool_k, pool_v, table, positions


@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_paged_plain_matches_pallas_and_stream(G, softcap):
    q, pk, pv, table, positions = _paged_inputs(G)
    jargs = tuple(map(jnp.asarray, (q, pk, pv, table, positions)))
    pallas = np.asarray(jpa.paged_attention_kernel(*jargs, softcap=softcap,
                                                   interpret=True))
    stream = np.asarray(jpa.paged_attention_stream(*jargs, softcap=softcap))
    got = tops.paged_attention(*map(torch.from_numpy,
                                    (q, pk, pv, table, positions)),
                               softcap=softcap)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), stream, rtol=0, atol=ATOL)
    assert (got[1] == 0).all()              # idle slot: exactly zero


def test_paged_plain_int8_lane_matches_stream():
    """The int8 pool lane runs in the plain version (CUDA raises)."""
    q, pk, pv, table, positions = _paged_inputs(2, seed=3)
    rng = np.random.RandomState(4)
    P, _, Hkv, _ = pk.shape
    k8 = rng.randint(-127, 128, size=pk.shape).astype(np.int8)
    v8 = rng.randint(-127, 128, size=pv.shape).astype(np.int8)
    ks = (rng.rand(P, Hkv) / 127).astype(np.float32)
    vs = (rng.rand(P, Hkv) / 127).astype(np.float32)
    ref = np.asarray(jpa.paged_attention_stream(
        *map(jnp.asarray, (q, k8, v8, table, positions)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = tpa.paged_attention(*map(torch.from_numpy,
                                   (q, k8, v8, table, positions)),
                              k_scale=torch.from_numpy(ks),
                              v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


# the shapes the card serves in its wide tile and in group tiles of 16:
# D = 256 at G = 8, and Falcon-7B's attention (71 query heads over one KV
# head of 64: tiles of 16, 16, 16, 16, 7)
WIDE_PAGED = {"d256_g8": dict(G=8, Hkv=1, D=256),
              "d64_g71": dict(G=71, Hkv=1, D=64)}


def _int8_pool(rng, pk, pv):
    """int8 codes and (P, Hkv) float32 scales in place of a float pool."""
    P, _, Hkv, _ = pk.shape
    k8 = rng.randint(-127, 128, size=pk.shape).astype(np.int8)
    v8 = rng.randint(-127, 128, size=pv.shape).astype(np.int8)
    ks = (rng.rand(P, Hkv) / 127).astype(np.float32)
    vs = (rng.rand(P, Hkv) / 127).astype(np.float32)
    return k8, v8, ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(WIDE_PAGED))
def test_paged_wide_and_grouped_match_pallas_and_stream(name, int8):
    """The plain version at D = 256 and at G = 71, on the float and the
    int8 pool lanes, against ``repro``'s Pallas kernel in interpret mode
    and its ``paged_attention_stream``."""
    q, pk, pv, table, positions = _paged_inputs(seed=5, **WIDE_PAGED[name])
    scales = {}
    if int8:
        pk, pv, ks, vs = _int8_pool(np.random.RandomState(6), pk, pv)
        scales = {"k_scale": ks, "v_scale": vs}
    jargs = tuple(map(jnp.asarray, (q, pk, pv, table, positions)))
    jscales = {n: jnp.asarray(a) for n, a in scales.items()}
    pallas = np.asarray(jpa.paged_attention_kernel(
        *jargs, softcap=3.0, interpret=True, **jscales))
    stream = np.asarray(jpa.paged_attention_stream(*jargs, softcap=3.0,
                                                   **jscales))
    got = tpa.paged_attention(
        *map(torch.from_numpy, (q, pk, pv, table, positions)), softcap=3.0,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), stream, rtol=0, atol=ATOL)
    assert (got[1] == 0).all()              # idle slot: exactly zero
