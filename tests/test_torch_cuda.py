"""The port's CUDA kernels against their plain versions on the card, at
small shapes, and the serving path end to end on the card.  Marked
``cuda``; each test skips where no CUDA device is present (decided inside
the ``cuda`` fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 sums in another order, 1e-4 of the output's scale;
bf16 outputs, one bf16 step (2^-7 of the scale).  The quantized lanes get
the same int8 / int4 codes and scales as their plain versions, so they are
held at 1e-4 too; the gather is a copy and is held exactly.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.kernels import bc_fused as bcf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged as pg  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import spectral_matmul as sm  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      Request)
from repro_torch.serve.params import precompute_serving_params  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _close(got, ref, bf16=False):
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if bf16 else 1e-4) * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("B,p,q,k", [(3, 5, 13, 16), (8, 44, 16, 128),
                                     (70, 16, 44, 128)])
def test_bc_fused_kernel(cuda, B, p, q, k):
    w = torch.randn((p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    planes = cc.spectral_cache(w)
    xb = torch.randn((B, q, k), generator=cuda, device="cuda")
    before = bcf.KERNEL.launches
    got = bcf.bc_fused_matmul(xb, planes["wr"], planes["ws1"],
                              planes["ws2"], k)
    assert bcf.KERNEL.launches == before + 1
    _close(got, bcf.bc_fused_matmul_plain(xb, planes["wr"], planes["ws1"],
                                          planes["ws2"], k))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,p,q,k", [(3, 5, 13, 16), (8, 44, 16, 128),
                                     (70, 16, 44, 128)])
def test_bc_fused_quantized_lanes(cuda, bits, B, p, q, k):
    w = torch.randn((p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    qp = codec.quantize_plane_cache(cc.spectral_cache(w), bits)
    scales = [qp[n + "_s"] for n in ("wr", "ws1", "ws2")]
    xb = torch.randn((B, q, k), generator=cuda, device="cuda")
    lane = "bc_fused_i8" if bits == 8 else "bc_fused_i4"
    before = dict(bcf.KERNEL.fn_launches)
    got = bcf.bc_fused_matmul(xb, qp["wr"], qp["ws1"], qp["ws2"], k, scales)
    after = bcf.KERNEL.fn_launches
    assert {f: after[f] - before[f] for f in after} == {
        f: int(f == lane) for f in after}
    _close(got, bcf.bc_fused_matmul_plain(xb, qp["wr"], qp["ws1"],
                                          qp["ws2"], k, scales))


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("p,q", [(1, 13), (2, 16), (3, 44), (86, 16),
                                 (16, 86), (76, 20)])
@pytest.mark.parametrize("B", [1, 3, 8, 70, 256])
def test_bc_fused_tiling_edges(cuda, B, p, q, k):
    """The launch plan's edges: one row, ragged row tiles, q-split (p < 4)
    and p-split clusters, chunked q, on all three lanes."""
    w = torch.randn((p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    planes = cc.spectral_cache(w)
    xb = torch.randn((B, q, k), generator=cuda, device="cuda")
    variants = [((planes["wr"], planes["ws1"], planes["ws2"]), None)]
    for bits in (8, 4):
        qp = codec.quantize_plane_cache(planes, bits)
        variants.append(((qp["wr"], qp["ws1"], qp["ws2"]),
                         [qp[n + "_s"] for n in ("wr", "ws1", "ws2")]))
    for pl, scales in variants:
        before = bcf.KERNEL.launches
        got = bcf.bc_fused_matmul(xb, *pl, k, scales)
        assert bcf.KERNEL.launches == before + 1
        _close(got, bcf.bc_fused_matmul_plain(xb, *pl, k, scales))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [dict(), dict(window=8),
                                  dict(softcap=5.0, kv_offset=16),
                                  dict(causal=False), dict(kv_offset=-4)])
def test_flash_kernel(cuda, dtype, opts):
    Sq = 8 if "kv_offset" in opts else 37
    q = torch.randn((2, 8, Sq, 64), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((2, 2, 37 if Sq == 37 else 24, 64), generator=cuda,
                    device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=cuda, device="cuda").to(dtype)
    got = fa.flash_attention(q, k, v, **opts)
    _close(got, fa.attention_ref(q, k, v, **opts), dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 230])
def test_flash_kernel_dense_decode(cuda, dtype, pos):
    """The batch engine's decode: one query row (31 of the block's 32 rows
    idle) over the cache's first pos + 1 rows, kv_offset = pos."""
    B, Hq, Hkv, D = 8, 32, 4, 64
    q = torch.randn((B, Hq, 1, D), generator=cuda, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, pos + 1, D), generator=cuda,
                    device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=cuda, device="cuda").to(dtype)
    got = fa.flash_attention(q, k, v, causal=True, kv_offset=pos)
    _close(got, fa.attention_ref(q, k, v, causal=True, kv_offset=pos),
           dtype == torch.bfloat16)


@pytest.mark.parametrize("opts", ["last", "window_softcap", "half_masked",
                                  "all_masked"])
@pytest.mark.parametrize("Skv", [1, 31, 32, 33, 231, 1000])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_packing_and_split(cuda, dtype, D, G, Skv, opts):
    """One query row per (batch, head) with the G heads of a KV head packed
    into one block and, in float32, the keys split over blocks: windows,
    softcap and kv_offset under packing and split; a split (or a whole
    row) with no valid key."""
    B, Hkv = 3, 2
    kw = {"last": dict(kv_offset=Skv - 1),
          "window_softcap": dict(kv_offset=Skv - 1, window=40, softcap=4.0),
          "half_masked": dict(kv_offset=Skv // 2),
          "all_masked": dict(kv_offset=-1)}[opts]
    q = torch.randn((B, Hkv * G, 1, D), generator=cuda,
                    device="cuda").to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=cuda, device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=cuda, device="cuda").to(dtype)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=True, **kw)
    assert fa.KERNEL.launches == before + 1
    if opts == "all_masked":
        assert (got == 0).all()
    _close(got, fa.attention_ref(q, k, v, causal=True, **kw),
           dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 63, 65, 200])
def test_flash_kernel_head_dim_128(cuda, dtype, S):
    """qwen's head dim (the other bf16 tensor-core tiling), causal prefill
    at ragged lengths, G = 8 and G = 4."""
    for Hq, Hkv in ((16, 2), (32, 8)):
        q = torch.randn((1, Hq, S, 128), generator=cuda,
                        device="cuda").to(dtype)
        k = torch.randn((1, Hkv, S, 128), generator=cuda,
                        device="cuda").to(dtype)
        v = torch.randn(k.shape, generator=cuda, device="cuda").to(dtype)
        _close(fa.flash_attention(q, k, v), fa.attention_ref(q, k, v),
               dtype == torch.bfloat16)


# (F, N, Q, P): odd F, ragged N, Q != P, P = 2, and the q = 86 / 76 shapes
@pytest.mark.parametrize("F,N,Q,P", [(9, 37, 8, 16), (65, 100, 16, 2),
                                     (65, 70, 44, 16), (65, 33, 16, 44),
                                     (65, 20, 86, 16), (65, 21, 20, 76)])
def test_spectral_matmul_kernel(cuda, F, N, Q, P):
    xr, xi = (torch.randn((F, N, Q), generator=cuda, device="cuda")
              for _ in range(2))
    wr, ws1, ws2 = (torch.randn((F, Q, P), generator=cuda, device="cuda")
                    for _ in range(3))
    before = sm.KERNEL.launches
    yr, yi = sm.spectral_matmul(xr, xi, wr, ws1, ws2)
    assert sm.KERNEL.launches == before + 1
    rr, ri = sm.spectral_matmul_plain(xr, xi, wr, ws1, ws2)
    _close(yr, rr)
    _close(yi, ri)
    # through the hook: (..., q, kf) planes against a (p, q, kf) cache
    cache = {n: t.permute(2, 1, 0).contiguous()
             for n, t in (("wr", wr), ("ws1", ws1), ("ws2", ws2))}
    xr2, xi2 = (t.permute(1, 2, 0).reshape(N, Q, F) for t in (xr, xi))
    hr, hi = kops.spectral_contract(xr2, xi2, cache)
    _close(hr, rr.permute(1, 2, 0))
    _close(hi, ri.permute(1, 2, 0))


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("G", [1, 8])
def test_paged_kernel(cuda, G, q_dtype, kv_dtype):
    Hkv, D, page, maxp, B = 2, 64, 4, 6, 4
    P = B * maxp + 1
    pool_k = torch.randn((P, page, Hkv, D), generator=cuda,
                         device="cuda").to(kv_dtype)
    pool_v = torch.randn(pool_k.shape, generator=cuda,
                         device="cuda").to(kv_dtype)
    perm = torch.randperm(P - 1, generator=cuda, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    positions = torch.tensor([9, -1, 23, 0], dtype=torch.int32,
                             device="cuda")
    q = torch.randn((B, Hkv * G, D), generator=cuda,
                    device="cuda").to(q_dtype)
    got = pa.paged_attention(q, pool_k, pool_v, table, positions,
                             softcap=3.0)
    assert (got[1] == 0).all()
    _close(got, pa.paged_attention_stream(q, pool_k, pool_v, table,
                                          positions, softcap=3.0),
           q_dtype == torch.bfloat16)
    # the int8 lane on the same values, quantized per (page, head)
    k8, ks = codec.quantize_page_block(pool_k.float())
    v8, vs = codec.quantize_page_block(pool_v.float())
    before = pa.KERNEL.fn_launches["paged_attention_i8"]
    got = pa.paged_attention(q, k8, v8, table, positions, softcap=3.0,
                             k_scale=ks, v_scale=vs)
    assert pa.KERNEL.fn_launches["paged_attention_i8"] == before + 1
    assert (got[1] == 0).all()
    _close(got, pa.paged_attention_stream(q, k8, v8, table, positions,
                                          softcap=3.0, k_scale=ks,
                                          v_scale=vs),
           q_dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("H,D", [(4, 64), (3, 5)])   # 16-byte and ragged pages
def test_paged_gather_kernel(cuda, dtype, H, D):
    P, page, B, maxp = 13, 4, 3, 4
    pool = (torch.randn((P, page, H, D), generator=cuda, device="cuda")
            * 40).to(dtype)
    perm = torch.randperm(P - 1, generator=cuda, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    table[2, 3] = 0
    before = pg.KERNEL.launches
    got = pg.paged_gather(pool, table)
    assert pg.KERNEL.launches == before + 1
    assert torch.equal(got, pg.paged_gather_plain(pool, table))


@pytest.mark.parametrize("quant,paged_attn", [
    (None, "stream"), (codec.QuantPolicy("int8", True, 8), "stream"),
    (codec.QuantPolicy("int8", True, 4), "gather")])
def test_engine_on_card_matches_cpu(cuda, quant, paged_attn):
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i)
            for i, (s, n) in enumerate([(20, 9), (12, 14), (9, 6)])]
    # planes baked (and quantized) once on the CPU, so both devices serve
    # the same codes
    base = precompute_serving_params(init_params(cfg, seed=0, device="cpu"),
                                     cfg, quant)
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        eng = ContinuousEngine(cfg, model, max_slots=2, max_seq=32,
                               page_size=4, decode_chunk=4, device=dev,
                               quant=quant, paged_attn=paged_attn)
        out[dev] = [r["tokens"] for r in eng.generate(reqs)]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("quant", [None,
                                   codec.QuantPolicy(quant_weights=True)])
def test_batch_engine_on_card_matches_cpu(cuda, quant):
    """The batch engine on the card (the spectral_matmul hook at prefill
    for float32 planes, bc_fused at decode, flash at both) against the
    CPU's plain path: identical greedy tokens."""
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i)
            for i, (s, n) in enumerate([(20, 9), (12, 14), (9, 6)])]
    base = precompute_serving_params(init_params(cfg, seed=0, device="cpu"),
                                     cfg, quant)
    out = {}
    for dev in ("cpu", "cuda"):
        before = sm.KERNEL.launches
        eng = Engine(cfg, copy.deepcopy(base).to(dev), max_batch=2,
                     max_seq=32, device=dev, quant=quant)
        out[dev] = [r["tokens"] for r in eng.generate(reqs)]
        hooked = 7 * cfg.num_layers * eng.stats()["prefills"]
        want = hooked if dev == "cuda" and quant is None else 0
        assert sm.KERNEL.launches == before + want
    assert out["cuda"] == out["cpu"]
