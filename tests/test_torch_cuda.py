"""The port's CUDA kernels against their plain versions on the card, at
small shapes, and the serving path end to end on the card.  Marked
``cuda``; each test skips where no CUDA device is present (decided inside
the ``cuda`` fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 sums in another order, 1e-4 of the output's scale;
bf16 outputs, one bf16 step (2^-7 of the scale).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.kernels import bc_fused as bcf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, Request  # noqa: E402

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
    with pytest.raises(NotImplementedError):
        pa.paged_attention(q, pool_k, pool_v, table, positions,
                           k_scale=torch.ones((P, Hkv), device="cuda"),
                           v_scale=torch.ones((P, Hkv), device="cuda"))


def test_engine_on_card_matches_cpu(cuda):
    cfg = get_smoke_config("tinyllama-1.1b").replace(dtype="float32")
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i)
            for i, (s, n) in enumerate([(20, 9), (12, 14), (9, 6)])]
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_params(cfg, seed=0, device="cpu").to(dev)
        eng = ContinuousEngine(cfg, model, max_slots=2, max_seq=32,
                               page_size=4, decode_chunk=4, device=dev)
        out[dev] = [r["tokens"] for r in eng.generate(reqs)]
    assert out["cuda"] == out["cpu"]
