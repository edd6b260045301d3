"""The launch plans of the port's redesigned CUDA kernels, and the arithmetic
the kernels rely on, checked on the CPU (no card needed).

- ``bc_fused``: for every projection of tinyllama-1.1b, qwen2.5-3b and
  qwen3-4b and B in {1, 8, 64, 208, 256, 2048}, the plan covers every
  output row and block exactly once, computes each row's DFT exactly once,
  fits the H100's shared memory and a portable cluster, and at B = 8
  launches a full cluster of 8 blocks per row.
- ``flash_attention``: the same properties of its plan at one query row
  (G in {1, 4, 8}) and at prefill.
- 3xTF32: a numpy emulation of TF32 rounding (``cvt.rna``) on the k = 128
  DFT -> iDFT round trip, against float64.
- Split-KV: the combine of per-split (m, l, acc) in plain PyTorch against
  ``attention_ref``, with splits (and rows) in which every key is masked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.kernels import bc_fused as bcf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b")
BATCHES = (1, 8, 64, 208, 256, 2048)


def _block_shapes():
    """(arch, projection, p, q, k) of every distinct projection."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        a, k = cfg.attention, cfg.compression.block_attn
        d, hq, hkv = cfg.d_model, a.num_heads * a.head_dim, \
            a.num_kv_heads * a.head_dim
        ios = {"q": (d, hq), "o": (hq, d), "k_v": (d, hkv),
               "up_gate": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
        seen = set()
        for name, (n_in, n_out) in ios.items():
            p, q = cc.num_blocks(n_out, k), cc.num_blocks(n_in, k)
            if (p, q) not in seen:
                seen.add((p, q))
                out.append((arch, name, p, q, k))
    return out


SHAPES = _block_shapes()


def _bc_coverage(pl, B, p, q, k):
    """What the kernel's indexing does with a plan, replayed on the host:
    ``out[b, i, t]`` counts the blocks that write output row b, block i,
    8-column tile t; ``dft[b, j]`` counts the DFTs of input row b, block j.
    A sound plan gives 1 everywhere in both."""
    out = torch.zeros((B, p, k // 8), dtype=torch.int64)
    dft = torch.zeros((B, q), dtype=torch.int64)
    R, cs = pl.rows, pl.cluster
    for row0 in range(0, B, R):
        nrow = min(R, B - row0)
        for rank in range(cs):
            if pl.mode == bcf.P_SPLIT:
                i0 = rank * pl.share
                out[row0:row0 + nrow, i0:i0 + max(0, min(pl.share,
                                                         p - i0))] += 1
                for c0 in range(0, q, pl.qchunk):
                    qcur = min(pl.qchunk, q - c0)
                    per = -(-R * qcur // cs)
                    for m in range(rank * per, min((rank + 1) * per,
                                                   R * qcur)):
                        if m % R < nrow:
                            dft[row0 + m % R, c0 + m // R] += 1
            else:
                j0 = rank * pl.share
                dft[row0:row0 + nrow, j0:j0 + max(0, min(pl.share,
                                                         q - j0))] += 1
                per = -(-(k // 8) // cs)
                t0 = min(k // 8, rank * per)
                out[row0:row0 + nrow, :, t0:min(k // 8, t0 + per)] += 1
    return out, dft


def _flash_coverage(pl, B, Hq, Hkv, Sq, Skv):
    """The kernel's indexing replayed on the host: ``rows[b, h, s]`` counts
    the blocks (of split 0) that own query row (b, h, s); ``keys[c]`` the
    splits whose range holds key c.  A sound plan gives 1 everywhere."""
    rows = torch.zeros((B, Hq, Sq), dtype=torch.int64)
    keys = torch.zeros((Skv,), dtype=torch.int64)
    if pl.dtype == torch.bfloat16:
        for r0 in range(0, Sq, fa.BF16_ROWS):
            rows[:, :, r0:r0 + fa.BF16_ROWS] += 1
    else:
        G = Hq // Hkv
        for pr0 in range(0, G * Sq, pl.rows):
            for pr in range(pr0, min(pr0 + pl.rows, G * Sq)):
                for hk in range(Hkv):
                    rows[:, hk * G + pr % G, pr // G] += 1
    for split in range(pl.splits):
        keys[split * pl.chunk:(split + 1) * pl.chunk] += 1
    return rows, keys


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch,proj,p,q,k", SHAPES,
                         ids=[f"{s[0]}-{s[1]}" for s in SHAPES])
def test_bc_fused_plan(arch, proj, p, q, k, B):
    lanes = [bcf.plan(B, p, q, k, lane) for lane in bcf.LANES.values()]
    assert len(set(lanes)) == 1             # the lanes share one plan
    pl = lanes[0]
    assert pl.smem_bytes <= bcf.MAX_SMEM == 232448
    assert pl.smem_bytes == bcf.smem_bytes(p, q, k, pl.rows, pl.cluster,
                                           pl.mode, pl.share, pl.qchunk)
    assert pl.cluster in (1, 2, 4, 8) and pl.cluster <= bcf.MAX_CLUSTER
    assert 1 <= pl.rows <= max(1, B) and 1 <= pl.qchunk <= q
    out, dft = _bc_coverage(pl, B, p, q, k)
    assert bool((out == 1).all()), "an output tile is written 0 or 2+ times"
    assert bool((dft == 1).all()), "a row's DFT is computed 0 or 2+ times"
    tiles = -(-B // pl.rows)
    assert pl.blocks == tiles * pl.cluster
    # the stated target: rows a tile as few as fill whole waves of
    # clusters (15 of 8 blocks on an H100, 66 of 2), so one row a tile
    # while B is under a wave: at B = 8 a full cluster of 8 blocks a row,
    # 64 blocks, each row's DFT computed once
    wave = bcf.MAX_CLUSTERS[pl.cluster]
    waves = -(-tiles // wave)
    assert pl.rows == 1 or -(-B // (pl.rows - 1)) > waves * wave
    if B == 8:
        assert pl.blocks == 64 and pl.rows == 1 and pl.cluster == 8


@pytest.mark.parametrize("p,q,k", [(3, 5, 7), (3, 5, 0), (0, 4, 16)])
def test_bc_fused_plan_refuses(p, q, k):
    with pytest.raises(ValueError):
        bcf.plan(8, p, q, k)


def _heads(arch):
    a = get_config(arch).attention
    return a.num_heads, a.num_kv_heads, a.head_dim


FLASH_CASES = (
    # (B, Hq, Hkv, Sq, Skv, D, dtype): one-row decode, G = 1 / 4 / 8
    [(8, 8, 8, 1, skv, 64, torch.float32) for skv in (1, 33, 231, 1000)]
    + [(8, 32, 8, 1, skv, 128, torch.float32) for skv in (31, 231)]
    + [(8, 32, 4, 1, skv, 64, torch.float32) for skv in (32, 231, 1000)]
    + [(8, 16, 2, 1, 231, 128, torch.float32)]
    # prefill: bf16 serve shapes, the float32 parity prompt, ragged
    + [(1, *_heads(a)[:2], 256, 256, _heads(a)[2], torch.bfloat16)
       for a in ARCHS]
    + [(1, 32, 4, 48, 48, 64, torch.float32),
       (2, 8, 2, 37, 37, 64, torch.float32),
       (2, 8, 2, 37, 37, 64, torch.bfloat16)])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,dtype", FLASH_CASES)
def test_flash_plan(B, Hq, Hkv, Sq, Skv, D, dtype):
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, dtype)
    assert pl.smem_bytes <= bcf.MAX_SMEM
    rows, keys = _flash_coverage(pl, B, Hq, Hkv, Sq, Skv)
    assert bool((rows == 1).all()) and bool((keys == 1).all())
    assert pl.chunk % fa.KEY_TILE == 0 or pl.splits == 1
    assert 1 <= pl.rows <= fa.F32_ROWS
    if dtype == torch.float32 and (Hq // Hkv) * Sq <= pl.rows:
        # one-row decode: enough blocks, or one per 32-key tile
        tiles = -(-Skv // fa.KEY_TILE)
        assert pl.blocks >= min(128, B * Hkv * tiles)
    if dtype == torch.bfloat16:
        assert pl.splits == 1


def test_flash_plan_refuses_untiled_bf16_head_dim():
    with pytest.raises(ValueError, match="tensor cores"):
        fa.plan(1, 8, 2, 16, 16, 80, torch.bfloat16)


# ---------------------------------------------------------------------------
# 3xTF32
# ---------------------------------------------------------------------------
def _tf32(a):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half of the dropped 13 bits to the magnitude)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product(a, b, mode):
    """a @ b with float32 accumulation over k in order, each product as
    the kernel forms it: 'f32' (float32 FMA), 'tf32' (one TF32 product),
    '3xtf32' (hi*hi, lo*hi and hi*lo each into its own sum, added at the
    end as acc + (sa + sb), as csrc/bc_fused.cu:tile_units does)."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    sa, sb = np.zeros_like(acc), np.zeros_like(acc)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    for kk in range(a.shape[1]):
        if mode == "f32":
            acc += np.outer(a[:, kk], b[kk]).astype(np.float32)
        elif mode == "tf32":
            acc += np.outer(ah[:, kk], bh[kk]).astype(np.float32)
        else:
            sa += np.outer(al[:, kk], bh[kk]).astype(np.float32)
            sb += np.outer(ah[:, kk], bl[kk]).astype(np.float32)
            acc += np.outer(ah[:, kk], bh[kk]).astype(np.float32)
    return acc + (sa + sb)


def _round_trip(x, mode, k=128):
    """x (M, k) -> rfft through the kernel's panel (Cr, Ci interleaved per
    bin) -> irfft through its transpose scaled per bin, both products in
    ``mode``."""
    panel = bcf.dft_panel(k, "cpu").numpy()
    X = _product(x, panel, mode)
    kf = k // 2 + 1
    w = np.full(kf, 2.0 / k, np.float32)
    w[0] = w[-1] = 1.0 / k
    wcol = np.zeros(panel.shape[1], np.float32)
    wcol[0:2 * kf:2], wcol[1:2 * kf:2] = w, w
    return _product(X * wcol, panel.T, mode)


def test_3xtf32_dft_round_trip_keeps_float32_accuracy():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 128).astype(np.float32)
    cr, ci, dr, di = (m.double().numpy() for m in cc.dft_mats(128))
    ref = (x.astype(np.float64) @ cr) @ dr + (x.astype(np.float64) @ ci) @ di
    scale = float(np.abs(ref).max())
    err = {m: float(np.abs(_round_trip(x, m) - ref).max())
           for m in ("f32", "3xtf32", "tf32")}
    print(f"k=128 DFT->iDFT round trip, max abs error (output scale "
          f"{scale:.3f}): {err}")
    assert err["3xtf32"] <= 2 * err["f32"]
    assert err["3xtf32"] <= 1e-5 * scale     # well inside 1e-4 of the scale
    # reported, not asserted: one TF32 product, the reason for the split
    # (about 1e-3 of the scale, past the f32 lane's 1e-4 tolerance)


def test_tf32_rounding_is_rna():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                # TF32's last mantissa bit
    half = np.float32(2.0 ** -11)
    vals = np.array([one + half, -(one + half), one + half * 0.99,
                     one + ulp + half], np.float32)
    got = _tf32(vals)
    assert got.tolist() == [one + ulp, -(one + ulp), one,
                            one + 2 * ulp]    # ties away from zero


# ---------------------------------------------------------------------------
# split-KV combine
# ---------------------------------------------------------------------------
def _split_attention(q, k, v, splits, chunk, causal=True, window=0,
                     softcap=0.0, kv_offset=0):
    """attention as the float32 lane computes it at decode: each split of
    ``chunk`` keys gives its (m, l, acc) over its valid keys (m = -1e30,
    l = 0, acc = 0 where it has none); the splits merge in order."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * D ** -0.5, kk)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq)[:, None] + kv_offset
    cols = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    parts = []
    for i in range(splits):
        sl = slice(i * chunk, min((i + 1) * chunk, Skv))
        ms, ss = mask[:, sl], s[..., sl]
        m = torch.where(ms, ss, torch.full_like(ss, -1e30)).amax(-1)
        p = torch.where(ms, torch.exp(ss - m[..., None]),
                        torch.zeros_like(ss))
        parts.append((m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p,
                                                 vv[:, :, sl])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    return acc / torch.clamp(l, min=1e-30)[..., None]


@pytest.mark.parametrize("opts", [dict(kv_offset=230),
                                  dict(kv_offset=230, window=50, softcap=4.),
                                  dict(kv_offset=70), dict(kv_offset=-1)])
def test_split_kv_combine_matches_attention_ref(opts):
    B, Hq, Hkv, Skv, D = 8, 32, 4, 231, 64
    pl = fa.plan(B, Hq, Hkv, 1, Skv, D, torch.float32)
    assert pl.splits > 1                      # the decode shape splits
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((B, Hq, 1, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    got = _split_attention(q, k, v, pl.splits, pl.chunk, **opts)
    ref = fa.attention_ref(q, k, v, causal=True, **opts)
    if opts["kv_offset"] < 0:                 # every split masked
        assert bool((got == 0).all()) and bool((ref == 0).all())
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
