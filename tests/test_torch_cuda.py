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
import dataclasses

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
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_packing_and_split(cuda, dtype, D, G, Skv, opts):
    """One query row per (batch, head) with the G heads of a KV head packed
    into one block and, in float32, the keys split over blocks and (G < 8)
    over the warps of a block: windows, softcap and kv_offset under
    packing and split; a split (or a whole row) with no valid key."""
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


# (F, N, Q, P): odd F, ragged N, Q != P, P = 2, and the q = 86 / 76 shapes;
# each in repro's contiguous layout and as the hook's views (bin-minor)
@pytest.mark.parametrize("layout", ["bin_major", "bin_minor"])
@pytest.mark.parametrize("F,N,Q,P", [(9, 37, 8, 16), (65, 100, 16, 2),
                                     (65, 70, 44, 16), (65, 33, 16, 44),
                                     (65, 20, 86, 16), (65, 21, 20, 76)])
def test_spectral_matmul_kernel(cuda, F, N, Q, P, layout):
    xr, xi = (torch.randn((F, N, Q), generator=cuda, device="cuda")
              for _ in range(2))
    wr, ws1, ws2 = (torch.randn((F, Q, P), generator=cuda, device="cuda")
                    for _ in range(3))
    if layout == "bin_minor":     # the same values through strided views
        xr, xi = (t.permute(1, 2, 0).contiguous().permute(2, 0, 1)
                  for t in (xr, xi))
        wr, ws1, ws2 = (t.permute(2, 1, 0).contiguous().permute(2, 1, 0)
                        for t in (wr, ws1, ws2))
    want = sm.BIN_MINOR if layout == "bin_minor" else sm.BIN_MAJOR
    assert sm.layout_of(xr, xi, wr, ws1, ws2) == want

    def call():
        return sm.spectral_matmul(xr, xi, wr, ws1, ws2)

    before = sm.KERNEL.launches
    yr, yi = call()
    assert sm.KERNEL.launches == before + 1
    assert yr.stride() == ((N * P, P, 1) if want == sm.BIN_MAJOR
                           else (1, P * F, F))    # X's layout
    rr, ri = sm.spectral_matmul_plain(xr, xi, wr, ws1, ws2)
    _close(yr, rr)
    _close(yi, ri)
    again = call()                                # no atomics: same bits
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)
    graph, out = _graph_call(call)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], yr) and torch.equal(out[1], yi)
    # through the hook: (..., q, kf) planes against a (p, q, kf) cache
    cache = {n: t.permute(2, 1, 0).contiguous()
             for n, t in (("wr", wr), ("ws1", ws1), ("ws2", ws2))}
    xr2, xi2 = (t.permute(1, 2, 0).contiguous().reshape(N, Q, F)
                for t in (xr, xi))
    hr, hi = kops.spectral_contract(xr2, xi2, cache)
    _close(hr, rr.permute(1, 2, 0))
    _close(hi, ri.permute(1, 2, 0))


def _graph_call(fn):
    """``fn()`` captured in a CUDA graph; returns (graph, its output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm: build, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


# (Hkv, G, D, page, maxp, B): split over pages (G = 1, 8, 16; D = 64 and
# 128), a run-time D with 16-byte loads (96), one that takes the scalar
# path (18), and one split where B * Hkv fills the card (70 * 2 blocks)
PAGED_SHAPES = [(2, 1, 64, 4, 6, 4), (2, 8, 64, 4, 6, 4),
                (2, 8, 128, 4, 6, 4), (2, 16, 64, 4, 6, 4),
                (4, 4, 96, 16, 5, 4), (2, 3, 18, 4, 6, 4),
                (2, 8, 64, 16, 3, 70)]


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("Hkv,G,D,page,maxp,B", PAGED_SHAPES)
def test_paged_kernel(cuda, Hkv, G, D, page, maxp, B, q_dtype, kv_dtype):
    P = B * maxp + 1
    pool_k = torch.randn((P, page, Hkv, D), generator=cuda,
                         device="cuda").to(kv_dtype)
    pool_v = torch.randn(pool_k.shape, generator=cuda,
                         device="cuda").to(kv_dtype)
    perm = torch.randperm(P - 1, generator=cuda, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    last = maxp * page - 1
    # idle, a page boundary, the table's last column, its first column
    pos = [9, -1, last, 0] + [(7 * i) % (last + 1) for i in range(B - 4)]
    positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hkv * G, D), generator=cuda,
                    device="cuda").to(q_dtype)
    pl = pa.plan(B, Hkv * G, Hkv, D, page, maxp, kv_dtype)
    assert (pl.splits > 1) == (B * Hkv < pa.SMS)
    # the int8 lane on the same values, quantized per (page, head)
    k8, ks = codec.quantize_page_block(pool_k.float())
    v8, vs = codec.quantize_page_block(pool_v.float())
    lanes = {"paged_attention": (pool_k, pool_v, {}),
             "paged_attention_i8": (k8, v8, {"k_scale": ks, "v_scale": vs})}
    for lane, (pk, pv, scales) in lanes.items():
        def call():
            return pa.paged_attention(q, pk, pv, table, positions,
                                      softcap=3.0, **scales)
        before = dict(pa.KERNEL.fn_launches)
        got = call()
        after = pa.KERNEL.fn_launches
        assert {f: after[f] - before[f] for f in after} == {
            f: int(f == lane) for f in after}   # one launch, this lane
        assert (got[1] == 0).all()
        _close(got, pa.paged_attention_stream(q, pk, pv, table, positions,
                                              softcap=3.0, **scales),
               q_dtype == torch.bfloat16)
        assert torch.equal(call(), got)         # merged in a fixed order
        graph, out = _graph_call(call)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)            # replay = eager, bit for bit


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


@pytest.mark.parametrize("dtype,S", [
    *[(dt, s) for dt in (torch.float32, torch.bfloat16)
      for s in (1, 63, 65, 200, 640)],
    *[(torch.float32, s) for s in (16, 17, 600)]])
def test_flash_kernel_head_dim_96(cuda, dtype, S):
    """phi-3-vision's head dim (the bf16 lane's D = 96 instance; the
    float32 tensor-core prefill from 16 packed rows): causal prefill at
    ragged lengths, MHA (32 / 32) and G = 4, then the batch engine's
    one-row decode over the same keys."""
    for Hq, Hkv in ((32, 32), (8, 2)):
        q = torch.randn((1, Hq, S, 96), generator=cuda,
                        device="cuda").to(dtype)
        k = torch.randn((1, Hkv, S, 96), generator=cuda,
                        device="cuda").to(dtype)
        v = torch.randn(k.shape, generator=cuda, device="cuda").to(dtype)
        before = fa.KERNEL.launches
        _close(fa.flash_attention(q, k, v), fa.attention_ref(q, k, v),
               dtype == torch.bfloat16)
        assert fa.KERNEL.launches == before + 1
        row = q[:, :, -1:].contiguous()
        _close(fa.flash_attention(row, k, v, kv_offset=S - 1),
               fa.attention_ref(row, k, v, kv_offset=S - 1),
               dtype == torch.bfloat16)


@pytest.mark.parametrize("opts", [dict(window=40), dict(softcap=5.0),
                                  dict(window=24, softcap=3.0, kv_offset=9),
                                  dict(causal=False), dict(kv_offset=-20)])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("S", [16, 17, 600])
def test_flash_f32_tensor_core_prefill(cuda, S, D, opts):
    """The float32 prefill on the tensor cores (3xTF32) at every head dim
    it has, MHA and G = 4: windows, softcap, kv_offset, no mask, and rows
    that see no key at all (exactly 0); within 1e-4 of the scale of
    ``attention_ref``."""
    for Hq, Hkv in ((32, 32), (8, 2)):
        q = torch.randn((1, Hq, S, D), generator=cuda, device="cuda")
        k = torch.randn((1, Hkv, S, D), generator=cuda, device="cuda")
        v = torch.randn(k.shape, generator=cuda, device="cuda")
        assert fa.plan(1, Hq, Hkv, S, S, D, torch.float32).path == "f32_mma"
        before = fa.KERNEL.path_launches.get("f32_mma", 0)
        got = fa.flash_attention(q, k, v, **opts)
        assert fa.KERNEL.path_launches["f32_mma"] == before + 1
        ref = fa.attention_ref(q, k, v, **opts)
        _close(got, ref)
        if opts.get("kv_offset", 0) < 0:
            dead = ref.abs().amax(-1) == 0        # rows before the first key
            assert bool(dead.any()) and (got[dead] == 0).all()


# head dim 256 (gemma2, recurrentgemma): (B, Hq, Hkv, Sq, Skv), dtype,
# options, the kernel the plan must take.  Unit-variance scores barely
# reach a cap of 50; the last case of each lane caps at 4 with q scaled by
# 8 (``Q_SCALE``), where an uncapped kernel misses the tolerance by far.
Q_SCALE = 8.0
CAP4 = dict(softcap=4.0, q_scale=Q_SCALE)
HEAD_DIM_256 = [
    ((1, 4, 2, 4200, 4200), torch.bfloat16,
     dict(window=4096, softcap=50.0), "bf16"),
    ((2, 10, 1, 300, 300), torch.bfloat16, dict(softcap=50.0), "bf16"),
    ((1, 4, 2, 37, 37), torch.bfloat16, dict(causal=False), "bf16"),
    ((1, 16, 8, 700, 700), torch.bfloat16, dict(window=512, **CAP4), "bf16"),
    ((1, 4, 2, 4200, 4200), torch.float32,
     dict(window=4096, softcap=50.0), "f32_mma"),
    ((1, 10, 1, 300, 300), torch.float32, dict(window=100), "f32_mma"),
    ((1, 16, 8, 8, 8), torch.float32, dict(softcap=50.0), "f32_mma"),
    ((1, 10, 1, 300, 300), torch.float32, dict(window=100, **CAP4),
     "f32_mma"),
    ((1, 16, 8, 7, 500), torch.float32, dict(kv_offset=493), "f32_rows"),
    ((4, 10, 1, 1, 2100), torch.float32, dict(kv_offset=2099, window=2048),
     "f32_rows"),
    ((4, 10, 1, 1, 2033), torch.float32, dict(causal=False), "f32_rows"),
    ((4, 16, 8, 1, 4207), torch.float32, dict(kv_offset=4206, softcap=50.0),
     "f32_rows"),
    ((4, 16, 8, 1, 4089), torch.float32, dict(causal=False, softcap=50.0),
     "f32_rows"),
    ((2, 4, 4, 1, 300), torch.float32, dict(kv_offset=299, window=70),
     "f32_rows"),
    ((4, 10, 1, 1, 2100), torch.float32, dict(kv_offset=2099, **CAP4),
     "f32_rows")]


@pytest.mark.parametrize("shape,dtype,opts,path", HEAD_DIM_256)
def test_flash_kernel_head_dim_256(cuda, shape, dtype, opts, path):
    """Every lane at D = 256 against ``attention_ref``: the bf16 prefill
    and the float32 tensor-core prefill with gemma2's window of 4,096 and
    softcap 50 at 4,200 positions, at G = 10 (recurrentgemma) and ragged;
    the rows kernel at 14 packed rows, at G = 10 over 2,100 keys with a
    window of 2,048 and over a ring's 2,033 (not causal), gemma2's G = 2
    decode over 4,207 keys and its ring's 4,089, and G = 1 (8 key
    groups); on each lane a cap of 4 that bites."""
    B, Hq, Hkv, Sq, Skv = shape
    opts = dict(opts)
    q = opts.pop("q_scale", 1.0) * torch.randn((B, Hq, Sq, 256),
                                               generator=cuda, device="cuda")
    k = torch.randn((B, Hkv, Skv, 256), generator=cuda, device="cuda")
    v = torch.randn(k.shape, generator=cuda, device="cuda")
    q, k, v = (t.to(dtype) for t in (q, k, v))
    assert fa.plan(B, Hq, Hkv, Sq, Skv, 256, dtype).path == path
    before = fa.KERNEL.path_launches.get(path, 0)
    got = fa.flash_attention(q, k, v, **opts)
    assert fa.KERNEL.path_launches[path] == before + 1
    ref = fa.attention_ref(q, k, v, **opts)
    _close(got, ref, dtype == torch.bfloat16)
    if opts.get("softcap") == CAP4["softcap"]:      # the cap bites here
        bare = fa.flash_attention(q, k, v, **{**opts, "softcap": 0.0})
        with pytest.raises(AssertionError):
            _close(bare, ref, dtype == torch.bfloat16)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B", [1, 4])
def test_paged_kernel_phi3_mha(cuda, q_dtype, kv_dtype, B):
    """phi-3-vision's paged decode: 32 KV heads of 96, G = 1 (one query
    row a block), pages of 16, on both pool lanes."""
    Hkv, D, page, maxp = 32, 96, 16, 64
    P = B * maxp + 1
    pool_k = torch.randn((P, page, Hkv, D), generator=cuda,
                         device="cuda").to(kv_dtype)
    pool_v = torch.randn(pool_k.shape, generator=cuda,
                         device="cuda").to(kv_dtype)
    perm = torch.randperm(P - 1, generator=cuda, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    positions = torch.tensor([615, 700, -1, 1023][:B], dtype=torch.int32,
                             device="cuda")
    q = torch.randn((B, Hkv, D), generator=cuda, device="cuda").to(q_dtype)
    k8, ks = codec.quantize_page_block(pool_k.float())
    v8, vs = codec.quantize_page_block(pool_v.float())
    for pk, pv, scales in ((pool_k, pool_v, {}),
                           (k8, v8, {"k_scale": ks, "v_scale": vs})):
        got = pa.paged_attention(q, pk, pv, table, positions, **scales)
        _close(got, pa.paged_attention_stream(q, pk, pv, table, positions,
                                              **scales),
               q_dtype == torch.bfloat16)
        if B > 2:
            assert (got[2] == 0).all()


# expert shapes of llama4 (p / q of 64 / 40 and 40 / 64, rows of a
# decode's dropless buffer and of a prefill's capacity of 1) and
# phi-3-vision's up/gate
@pytest.mark.parametrize("B,p,q", [(4, 64, 40), (4, 40, 64), (1, 64, 40),
                                   (8, 64, 24)])
def test_bc_fused_expert_and_phi3_shapes(cuda, B, p, q):
    k = 128
    w = torch.randn((p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    planes = cc.spectral_cache(w)
    xb = torch.randn((B, q, k), generator=cuda, device="cuda")
    for bits in (None, 8, 4):
        qp = planes if bits is None else codec.quantize_plane_cache(planes,
                                                                    bits)
        scales = (None if bits is None
                  else [qp[n + "_s"] for n in ("wr", "ws1", "ws2")])
        pl = (qp["wr"], qp["ws1"], qp["ws2"])
        before = bcf.KERNEL.launches
        got = bcf.bc_fused_matmul(xb, *pl, k, scales)
        assert bcf.KERNEL.launches == before + 1
        _close(got, bcf.bc_fused_matmul_plain(xb, *pl, k, scales))


@pytest.mark.parametrize("C", [1, 4, 17])
@pytest.mark.parametrize("E", [1, 3, 128])
def test_bc_fused_expert_stack_is_the_per_expert_loop(cuda, E, C):
    """One launch over an expert stack equals the per-expert calls on
    views of the stack bit for bit, on all three lanes, eagerly and
    replayed from a CUDA graph."""
    k, p, q = 128, 16, 8
    w = torch.randn((E, p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    planes = cc.spectral_cache(w)
    xb = torch.randn((E, C, q, k), generator=cuda, device="cuda")
    for bits in (None, 8, 4):
        qp = planes if bits is None else codec.quantize_plane_cache(planes,
                                                                    bits)
        pl = (qp["wr"], qp["ws1"], qp["ws2"])
        scales = (None if bits is None
                  else [qp[n + "_s"] for n in ("wr", "ws1", "ws2")])
        before = bcf.KERNEL.launches
        got = bcf.bc_fused_matmul(xb, *pl, k, scales)
        assert bcf.KERNEL.launches == before + 1
        loop = torch.stack([bcf.bc_fused_matmul(
            xb[e], *(t[e] for t in pl), k,
            None if scales is None else [s[e] for s in scales])
            for e in range(E)])
        assert torch.equal(got, loop)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bcf.bc_fused_matmul(xb, *pl, k, scales)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replay = bcf.bc_fused_matmul(xb, *pl, k, scales)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replay, got)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_bc_expert_linear_on_card(cuda, bits):
    """An expert stack's projection: one fused-kernel launch for the whole
    stack, equal to the plain per-expert product."""
    E, C, k, n_in, n_out = 5, 3, 16, 48, 80
    w = torch.randn((E, n_out // k, n_in // k, k), generator=cuda,
                    device="cuda") / n_in ** .5
    cache = cc.spectral_cache(w)
    if bits is not None:
        cache = codec.quantize_plane_cache(cache, bits)
    x = torch.randn((E, C, n_in), generator=cuda, device="cuda")
    before = bcf.KERNEL.launches
    got = kops.bc_expert_linear(x, cache, k, n_out)
    assert bcf.KERNEL.launches == before + 1
    want = kops.bc_expert_linear(x.cpu(), {n: t.cpu() for n, t in
                                           cache.items()}, k, n_out)
    _close(got.cpu(), want)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "phi-3-vision-4.2b"])
def test_moe_and_vision_engines_on_card_match_cpu(cuda, arch):
    """llama4 (MoE, smoke) and phi-3-vision (the vision stub, smoke)
    through both engines on the card against the CPU's plain path: the
    same greedy tokens."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i)
            for i, (s, n) in enumerate([(20, 9), (16, 7), (12, 6)])]
    base = precompute_serving_params(init_params(cfg, seed=0, device="cpu"),
                                     cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        cont = ContinuousEngine(cfg, model, max_slots=2, max_seq=32,
                                page_size=4, decode_chunk=4, device=dev)
        batch = Engine(cfg, model, max_batch=2, max_seq=32, device=dev)
        out[dev] = [[r["tokens"] for r in eng.generate(reqs)]
                    for eng in (cont, batch)]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b"])
def test_gemma_engines_on_card_match_cpu(cuda, arch):
    """gemma2 and recurrentgemma (smoke widths, head dim 256, float32)
    through the batch engine on the card against the CPU's plain path:
    the same greedy tokens, the prefills on the float32 tensor-core
    kernel, the decode steps on the rows kernel."""
    c0 = get_smoke_config(arch)
    cfg = c0.replace(dtype="float32", attention=dataclasses.replace(
        c0.attention, head_dim=256))
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i)
            for i, (s, n) in enumerate([(20, 9), (17, 6)])]
    base = precompute_serving_params(init_params(cfg, seed=0, device="cpu"),
                                     cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, copy.deepcopy(base).to(dev), max_batch=2,
                     max_seq=32, device=dev)
        before = dict(fa.KERNEL.path_launches)
        out[dev] = [r["tokens"] for r in eng.generate(reqs)]
    after = fa.KERNEL.path_launches
    grew = {p: after.get(p, 0) - before.get(p, 0)
            for p in ("f32_mma", "f32_rows")}
    assert all(n > 0 for n in grew.values()), grew
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# training: bc_grad_w, the autograd Function, one train step
# ---------------------------------------------------------------------------
# tinyllama-1.1b's training shapes (q/o, k/v, up/gate, down, the fused
# q/k/v and up/gate) at fewer rows, a ragged small shape, and the plan's
# edges (kernels/bc_grad_w.py:plan): N not a multiple of the 64-row tile,
# k with a ragged last folded group (k = 200: k/4 = 50 of 56 positions,
# 64 bins a sub-panel, one DFT block an SM), k/4 odd (k = 24), 1,408
# pairs as 2 output tiles along q and as 11 along p, the latter in 2
# chunks (the scratch past 256 MiB), the last one short; and qwen3-4b's
# up/gate and down and phi-3-vision-4.2b's up/gate at N = 8 x 1,024
# (1,520 and 1,536 pairs: 3 output tiles along p or q, 2 chunks)
GRAD_W_SHAPES = [(1024, 16, 16, 128), (1024, 2, 16, 128),
                 (1024, 44, 16, 128), (1024, 16, 44, 128),
                 (1024, 20, 16, 128), (1024, 88, 16, 128), (37, 3, 5, 16),
                 (1000, 44, 16, 128), (300, 3, 5, 200), (100, 5, 3, 24),
                 (300, 16, 88, 128), (3000, 1408, 1, 16),
                 (8192, 76, 20, 128), (8192, 20, 76, 128),
                 (8192, 64, 24, 128)]


@pytest.mark.parametrize("N,p,q,k", GRAD_W_SHAPES)
def test_bc_grad_w_kernel(cuda, N, p, q, k):
    """The kernel against its plain version (float32 sums over N rows in
    another order: 1e-4 of the output's scale), and two calls bit-equal
    (the row splits are summed in a fixed order)."""
    from repro_torch.kernels import bc_grad_w as bgw
    gy = torch.randn((N, p, k), generator=cuda, device="cuda")
    xb = torch.randn((N, q, k), generator=cuda, device="cuda")
    before = bgw.KERNEL.launches
    got = bgw.bc_grad_w(gy, xb, k)
    again = bgw.bc_grad_w(gy, xb, k)
    assert bgw.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    _close(got, bgw.bc_grad_w_plain(gy, xb, k))


@pytest.mark.parametrize("gauss", [True, False])
def test_bc_matmul_fft_grads_on_card(cuda, gauss):
    """The Function's output and both grads on the card (bc_fused forward
    and adjoint, bc_grad_w) against the plain versions on the CPU.  The
    non-Gauss form has no kernel and raises on the card."""
    from repro_torch.kernels import bc_grad_w as bgw
    k, n_in, n_out = 16, 72, 40
    w = torch.randn((3, 5, k), generator=cuda, device="cuda") / n_in ** .5
    x = torch.randn((4, 6, n_in), generator=cuda, device="cuda")
    g = torch.randn((4, 6, n_out), generator=cuda, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        wd = w.detach().to(dev).requires_grad_()
        xd = x.detach().to(dev).requires_grad_()
        if dev == "cuda" and not gauss:
            with pytest.raises(NotImplementedError):
                cc.bc_matmul_fft(xd, wd, n_out, gauss)
            return
        fused, grads = bcf.KERNEL.launches, bgw.KERNEL.launches
        y = cc.bc_matmul_fft(xd, wd, n_out, gauss)
        y.backward(g.to(dev))
        if dev == "cuda":   # forward and adjoint, then the weight grad
            assert bcf.KERNEL.launches == fused + 2
            assert bgw.KERNEL.launches == grads + 1
        out[dev] = [t.detach().cpu() for t in (y, xd.grad, wd.grad)]
    for got, ref in zip(out["cuda"], out["cpu"]):
        _close(got, ref)


def test_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the tinyllama smoke config in float32 on the card
    (the kernels) and on the CPU (the plain versions), from the same
    weights and batch: the loss within 1e-5 of its scale, every grad and
    every updated parameter within 1e-4 of its scale."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=0)(0)
    opt = adamw.AdamWConfig(lr=1e-3)
    res = {}
    base = ts.init_state(cfg, opt, seed=0, device="cpu")["model"]
    for dev in ("cpu", "cuda"):
        state = ts.init_state(cfg, opt, model=copy.deepcopy(base).to(dev))
        step = ts.make_train_step(cfg, opt)
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        _, _, grads = step.grads(state, on_dev)
        state, metrics = step(state, on_dev)
        res[dev] = (float(metrics["loss"]),
                    [g.cpu() for gs in grads for g in gs],
                    [p.detach().cpu() for p in state["model"].parameters()])
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * max(
        1.0, abs(res["cpu"][0]))
    for got, ref in zip(res["cuda"][1] + res["cuda"][2],
                        res["cpu"][1] + res["cpu"][2]):
        _close(got, ref)


# ---------------------------------------------------------------------------
# training an expert stack: the bc_grad_w stack lane, bc_fused's stack
# forward and adjoint, the six other archs' train steps
# ---------------------------------------------------------------------------
# (E, C, p, q, k): mixtral's up/gate and down at train_mixtral (2 x 4,608
# tokens: 18 groups of 512, cap 160, so C = 2,880 rows an expert), llama4's
# at train_llama4 (8 x 1,024 tokens, cap 5: C = 80, four groups of 32
# experts), and ragged row counts (C not a multiple of the 64-row DFT tile)
STACK_SHAPES = [(8, 2880, 112, 32, 128), (8, 2880, 32, 112, 128),
                (128, 80, 64, 40, 128), (128, 80, 40, 64, 128),
                (5, 37, 3, 5, 16), (3, 200, 44, 16, 128)]


@pytest.mark.parametrize("E,C,p,q,k", STACK_SHAPES)
def test_bc_grad_w_stack_lane(cuda, E, C, p, q, k):
    """One ``bc_grad_w`` call (one count, on the ``experts`` path) over an
    expert stack: each expert's result equal to the single call on its
    rows bit for bit, and within 1e-4 of the plain version's scale."""
    from repro_torch.kernels import bc_grad_w as bgw
    gy = torch.randn((E, C, p, k), generator=cuda, device="cuda")
    xb = torch.randn((E, C, q, k), generator=cuda, device="cuda")
    before = bgw.KERNEL.path_launches.get("experts", 0)
    got = bgw.bc_grad_w(gy, xb, k)
    assert bgw.KERNEL.path_launches["experts"] == before + 1
    for e in range(E):
        assert torch.equal(got[e], bgw.bc_grad_w(gy[e], xb[e], k)), e
    ref = torch.stack([bgw.bc_grad_w_plain(gy[e], xb[e], k)
                       for e in range(E)])
    _close(got, ref)


@pytest.mark.parametrize("E,C,p,q,k", STACK_SHAPES)
def test_bc_fused_stack_forward_and_adjoint(cuda, E, C, p, q, k):
    """``bc_forward`` and ``bc_adjoint`` over an expert stack: one
    ``bc_fused`` launch each, every expert equal bit for bit to the single
    call on its rows and its views of the same planes (planes derived
    from one expert's generators alone may differ in their last bits: the
    DFT product takes another shape), within 1e-4 of the plain version's
    scale."""
    w = torch.randn((E, p, q, k), generator=cuda, device="cuda") / (q * k) ** .5
    xb = torch.randn((E, C, q, k), generator=cuda, device="cuda")
    gy = torch.randn((E, C, p, k), generator=cuda, device="cuda")
    planes = cc.spectral_cache(w)
    for fn, arg, cache in ((kops.bc_forward, xb, planes),
                           (kops.bc_adjoint, gy,
                            kops.adjoint_planes(planes))):
        pl = (cache["wr"], cache["ws1"], cache["ws2"])
        before = bcf.KERNEL.path_launches.get("experts", 0)
        got = fn(arg, w)
        assert bcf.KERNEL.path_launches["experts"] == before + 1
        assert torch.equal(got, bcf.bc_fused_matmul(arg, *pl, k))
        for e in range(E):
            one = bcf.bc_fused_matmul(arg[e], *(t[e] for t in pl), k)
            assert torch.equal(got[e], one), (fn.__name__, e)
        _close(got, torch.stack([bcf.bc_fused_matmul_plain(
            arg[e], *(t[e] for t in pl), k) for e in range(E)]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "gemma2-9b", "recurrentgemma-2b",
                                  "xlstm-125m", "whisper-large-v3"])
def test_other_archs_train_on_card_match_cpu(cuda, arch):
    """The smoke config of each arch that trains past ``attn`` blocks, in
    float32, 2 x 24 tokens, remat: the loss, aux and every grad on the
    card against the CPU's plain path (1e-5 of the loss, 1e-4 of each
    grad's scale; xlstm's 1e-3, its gradients' conditioning:
    tests/test_torch_train_cells.py:GRAD_TOL).  An MoE arch's expert
    stacks take one ``bc_grad_w`` call a projection and layer."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import bc_grad_w as bgw
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    cfg = get_smoke_config(arch).replace(dtype="float32", remat="full")
    batch = SyntheticLM(cfg, batch=2, seq=24, seed=0)(0)
    opt = adamw.AdamWConfig(lr=1e-3)
    base = ts.init_state(cfg, opt, seed=0, device="cpu")["model"]
    res = {}
    for dev in ("cpu", "cuda"):
        state = ts.init_state(cfg, opt, model=copy.deepcopy(base).to(dev))
        before = bgw.KERNEL.path_launches.get("experts", 0)
        _, m, grads = ts.make_train_step(cfg, opt).grads(
            state, {k: v.to(dev) for k, v in batch.items()})
        res[dev] = (m, [g.cpu() for gs in grads for g in gs])
        if dev == "cuda" and cfg.moe.num_experts:
            moe_layers = sum(1 for mod in state["model"].modules()
                             if type(mod).__name__ == "MoE")
            assert bgw.KERNEL.path_launches["experts"] - before == \
                3 * moe_layers
    for key in ("loss", "moe_aux"):
        a, b = float(res["cuda"][0][key]), float(res["cpu"][0][key])
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), key
    tol = 1e-3 if arch == "xlstm-125m" else 1e-4
    for got, ref in zip(res["cuda"][1], res["cpu"][1]):
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol * scale


def _capture_run(cfg, model, graphs, kv_dtype):
    """Two dispatches of the paged loop with the numerics capture over a
    random pool (slot 1 poisoned: NaN keys on its first page): each
    dispatch's tokens, anom and capture stats."""
    from repro_torch.serve import decode as tdec
    from repro_torch.serve import kvcache as tkv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    pool = tkv.build_pool(cfg, 13, 4, codec.QuantPolicy(kv_dtype),
                          device="cuda")
    for key, t in pool.items():
        if key.endswith("_scale"):
            t.copy_(0.01 + 0.02 * torch.rand(t.shape, generator=gen,
                                             device="cuda"))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    pool["k_scale" if kv_dtype == "int8" else "k"][:, 4] = float("nan")
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 9]],
                         dtype=torch.int32, device="cuda")
    loop = tdec.make_paged_decode_loop(cfg, 4, graphs=graphs,
                                       capture_stats=True)
    state = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in
             ([3, 7, 0, 9], [5, 2, -1, 6], [6, 4, 0, 0])]
    outs = []
    with torch.no_grad():
        for _ in range(2):
            buf, cur, pool, pos, rem, _, anom, _ = loop(
                model, state[0], pool, table, state[1], state[2])
            outs.append((buf.cpu(), anom.cpu(), loop.last_stats.cpu()))
            state = [cur, pos, rem]
    assert loop.captures == int(graphs)
    return outs


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_replayed_capture_stats_equal_eager(cuda, kv_dtype):
    """The numerics capture replayed from the step's CUDA graph equals the
    same step run eagerly, bit for bit, poisoned slot and all."""
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    model = precompute_serving_params(init_params(cfg, seed=0,
                                                  device="cuda"), cfg)
    eager = _capture_run(cfg, model, False, kv_dtype)
    replay = _capture_run(cfg, model, True, kv_dtype)
    for (b0, a0, s0), (b1, a1, s1) in zip(eager, replay):
        assert torch.equal(b0, b1) and torch.equal(a0, a1)
        assert torch.equal(s0.nan_to_num(-1.0), s1.nan_to_num(-1.0))
    assert bool(eager[0][1][1]) and float(eager[0][2][1, 3]) >= 1


@pytest.mark.parametrize("quant", [None, ("int8", 8)])
def test_profiled_fractions_on_card(cuda, quant):
    """Priced against the h100 spec, every dispatch kind of both engines
    on the card reads a roofline fraction in (0, 1], with capture on."""
    from repro_torch.obs import Obs
    from repro_torch.roofline.analysis import H100
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    policy = (codec.QuantPolicy(quant[0], quant_weights=True,
                                weight_bits=quant[1]) if quant
              else codec.QuantPolicy())
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=8, id=i) for i, s in enumerate((9, 23))]
    model = init_params(cfg, seed=0, device="cuda")
    for eng in (ContinuousEngine(cfg, model, max_slots=2, max_seq=48,
                                 page_size=4, decode_chunk=4, quant=policy,
                                 obs=Obs(hardware=H100), device="cuda"),
                Engine(cfg, copy.deepcopy(model), max_batch=2, max_seq=48,
                       quant=policy, obs=Obs(hardware=H100),
                       device="cuda")):
        eng.generate(reqs)
        roof = eng.stats()["roofline"]
        assert roof and eng.stats()["hardware"] == "h100"
        for kind, r in roof.items():
            assert r["dispatches"] > 0, kind
            assert 0 < r["roofline_frac"] <= r["roofline_frac_max"] <= 1, (
                kind, r)
