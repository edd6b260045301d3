"""The launch plans of the port's redesigned CUDA kernels, and the arithmetic
the kernels rely on, checked on the CPU (no card needed).

- ``bc_fused``: the integer arguments of a launch over an expert stack
  (one expert's plan, E and the contiguous strides per lane; E = 1 is the
  single call).  For every projection of tinyllama-1.1b, qwen2.5-3b,
  qwen3-4b, phi-3-vision-4.2b and llama4-maverick-400b-a17b (whose expert
  projections share the shapes of its dense MLP) and B in {1, 8, 64, 208,
  256, 2048}, the plan covers every
  output row and block exactly once, computes each row's DFT exactly once,
  fits the H100's shared memory and a portable cluster, and at B = 8
  launches a full cluster of 8 blocks per row.
  gemma2-9b's and recurrentgemma-2b's projections at B = 4 and 16,800.
- ``flash_attention``: the same properties of its plan at one query row
  (G in {1, 4, 8, 10}) and at prefill; the bf16 lane's head dims (64, 96,
  128 and 256) and their shared memory; the float32 kernel each shape
  takes (tensor cores from 16 packed rows at D = 64, 96, 128, 256); each
  lane at gemma2's and recurrentgemma's head dim 256, and D = 192
  refused; at the one-row
  decode, the key groups (every warp of a block busy, each key of a split
  scored by exactly one warp) and their warp-order merge, emulated in
  plain PyTorch against ``attention_ref``; one Q K^T / P V tile in
  3xTF32, emulated in numpy.
- 3xTF32: a numpy emulation of TF32 rounding (``cvt.rna``) on the k = 128
  DFT -> iDFT round trip, against float64.
- Split-KV: the combine of per-split (m, l, acc) in plain PyTorch against
  ``attention_ref``, with splits (and rows) in which every key is masked.
- ``paged_attention``: its plan at the heads of the three archs covers
  every page of the table exactly once, fits shared memory and takes no
  positions; the page-range split and its in-order merge, emulated in
  plain PyTorch, against ``paged_attention_stream`` over f32 and int8
  pools.
- ``spectral_matmul``: its plan at the 11 batch-prefill shapes, the card
  test's ragged ones and those gemma2 and recurrentgemma add, in both
  layouts, writes every output exactly once,
  fits shared memory and the grid, pads Q and P to multiples of 8, and
  refuses a Q that fits nothing; the 3xTF32 Gauss MAC at Q = 86, emulated
  in numpy, keeps float32 accuracy.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.kernels import bc_fused as bcf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import spectral_matmul as smm  # noqa: E402
from repro_torch.quant import codec  # noqa: E402

ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b")
# the archs ported since: phi-3-vision (MHA, head dim 96) and llama4 (GQA
# 40 / 8, its experts at the shapes of its dense MLP)
NEW_ARCHS = ("phi-3-vision-4.2b", "llama4-maverick-400b-a17b")
BATCHES = (1, 8, 64, 208, 256, 2048)


def _block_shapes(archs):
    """(arch, projection, p, q, k) of every distinct projection."""
    out = []
    for arch in archs:
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


SHAPES = _block_shapes(ARCHS + NEW_ARCHS)
# head dim 256: gemma2 (GQA 16 / 8) and recurrentgemma (MQA 10 / 1, whose
# RG-LRU projections share the (20, 20) of its q and o)
GEMMA_ARCHS = ("gemma2-9b", "recurrentgemma-2b")
GEMMA_SHAPES = _block_shapes(GEMMA_ARCHS)


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


@pytest.mark.parametrize("B", [1, 4, 16800])
@pytest.mark.parametrize("arch,proj,p,q,k", GEMMA_SHAPES,
                         ids=[f"{s[0]}-{s[1]}" for s in GEMMA_SHAPES])
def test_bc_fused_plan_gemma_shapes(arch, proj, p, q, k, B):
    """gemma2's (32, 28) (16, 28) (28, 32) (112, 28) (28, 112) and
    recurrentgemma's (20, 20) (2, 20) (60, 20) (20, 60) at the oracle's
    one row and a decode's 4 rows: the same properties; at 4 x 4,200 rows
    a plan that fits (its coverage, replayed on the host, would take
    minutes here)."""
    assert {(p_, q_) for _, _, p_, q_, _ in GEMMA_SHAPES} == {
        (32, 28), (16, 28), (28, 32), (112, 28), (28, 112), (20, 20),
        (2, 20), (60, 20), (20, 60)}
    if B <= max(BATCHES):
        test_bc_fused_plan(arch, proj, p, q, k, B)
        return
    pl = bcf.plan(B, p, q, k)
    assert pl.smem_bytes <= bcf.MAX_SMEM
    assert pl.smem_bytes == bcf.smem_bytes(p, q, k, pl.rows, pl.cluster,
                                           pl.mode, pl.share, pl.qchunk)
    assert pl.blocks == -(-B // pl.rows) * pl.cluster


@pytest.mark.parametrize("p,q,k", [(3, 5, -8), (3, 5, 0), (0, 4, 16)])
def test_bc_fused_plan_refuses(p, q, k):
    with pytest.raises(ValueError):
        bcf.plan(8, p, q, k)


@pytest.mark.parametrize("lane", list(bcf.LANES.values()))
@pytest.mark.parametrize("E", [1, 3, 128])
@pytest.mark.parametrize("B,p,q,k", [(4, 64, 40, 128), (4, 40, 64, 128),
                                     (17, 2, 16, 128), (3, 5, 13, 16)])
def test_bc_fused_expert_stack_args(B, p, q, k, E, lane):
    """A launch over an expert stack passes one expert's shape and plan,
    then E and the strides between experts of contiguous stacks, each in
    its tensor's elements (the int4 lane's planes in packed bytes); a pure
    function of the shapes, and at E = 1 the single call's arguments."""
    assert list(inspect.signature(bcf.launch_args).parameters) == [
        "B", "p", "q", "k", "lane", "E"]
    args = bcf.launch_args(B, p, q, k, lane, E)
    assert args == bcf.launch_args(B, p, q, k, lane, E)
    pl = bcf.plan(B, p, q, k, lane)
    assert args[:9] == (B, p, q, k, pl.rows, pl.cluster, pl.mode, pl.share,
                        pl.qchunk)
    assert args[9] == E
    kf = k // 2 + 1
    plane_dtype = {v: d for d, v in bcf.LANES.items()}[lane]
    row = (kf + 1) // 2 if plane_dtype == torch.uint8 else kf
    stacks = (torch.empty((E, B, q, k)),
              torch.empty((E, p, q, row), dtype=plane_dtype),
              torch.empty((E, p, 1)), torch.empty((E, B, p, k)))
    assert args[10:] == tuple(t.stride(0) for t in stacks)
    if E == 1:
        assert bcf.launch_args(B, p, q, k, lane) == args


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
       for a in ARCHS + NEW_ARCHS]
    + [(1, 32, 4, 48, 48, 64, torch.float32),
       (2, 8, 2, 37, 37, 64, torch.float32),
       (2, 8, 2, 37, 37, 64, torch.bfloat16)]
    # phi-3-vision (MHA, D = 96): its serve prefills, the float32 oracle
    # prompt and its one-row decode
    + [(1, 32, 32, 768, 768, 96, torch.bfloat16),
       (4, 32, 32, 760, 760, 96, torch.bfloat16),
       (1, 32, 32, 600, 600, 96, torch.float32),
       (1, 32, 32, 1, 615, 96, torch.float32)]
    # serve_phi3's last decode step, the tensor-core prefill's smallest
    # shapes (16 packed rows, one over), G = 2 and 4 decode (key groups)
    + [(4, 32, 32, 1, 775, 96, torch.float32),
       (1, 32, 32, 16, 16, 96, torch.float32),
       (1, 32, 32, 17, 17, 96, torch.float32),
       (1, 8, 2, 3, 300, 128, torch.float32),
       (3, 8, 4, 1, 100, 64, torch.float32)]
    # head dim 256: gemma2's global and ring decode (G = 2), its batch
    # prefill; recurrentgemma's ring decode (G = 10) and oracle prefill
    + [(4, 16, 8, 1, 4207, 256, torch.float32),
       (4, 16, 8, 1, 4090, 256, torch.float32),
       (4, 16, 8, 4200, 4200, 256, torch.bfloat16),
       (4, 10, 1, 1, 2048, 256, torch.float32),
       (1, 10, 1, 2100, 2100, 256, torch.float32)])


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


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 32, 32, 600, 600, 96), (1, 32, 32, 16, 16, 64),
    (1, 8, 2, 8, 40, 128), (2, 8, 2, 37, 37, 64), (1, 32, 32, 15, 15, 96),
    (1, 32, 32, 600, 600, 80), (8, 32, 4, 1, 231, 64)])
def test_flash_f32_kernel_choice(B, Hq, Hkv, Sq, Skv, D):
    """float32 takes the tensor-core prefill from 16 packed rows (G heads
    x Sq positions) at D = 64, 96, 128, one block per 64 packed rows and
    no split; fewer rows, or another head dim, take the rows kernel."""
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, torch.float32)
    packed = (Hq // Hkv) * Sq
    mma = packed >= fa.F32_MMA_MIN_ROWS and D in fa.F32_MMA_HEAD_DIMS
    assert pl.path == ("f32_mma" if mma else "f32_rows")
    if mma:
        assert (pl.rows, pl.splits, pl.key_groups) == (fa.F32_MMA_ROWS, 1, 1)
        assert pl.blocks == -(-packed // fa.F32_MMA_ROWS) * B * Hkv
        assert pl.smem_bytes == 4 * (64 * (D + 4) + 2 * 32 * (2 * D + 12))
    assert pl.smem_bytes <= bcf.MAX_SMEM


# the one-row decode shapes whose blocks hold fewer packed rows than warps
KEY_GROUP_CASES = [(4, 32, 32, 1, 775, 96), (1, 32, 32, 1, 615, 96),
                   (8, 8, 8, 1, 33, 64), (3, 2, 2, 1, 1000, 64),
                   (8, 16, 4, 1, 231, 128), (2, 4, 2, 1, 100, 64),
                   (1, 4, 4, 1, 31, 96)]


def _group_keys(pl, Skv, split, group):
    """The keys warp group ``group`` of split ``split`` scores: in every
    32-key stage of the split's range, its nk = 32 / key_groups keys."""
    lo, hi = split * pl.chunk, min(Skv, (split + 1) * pl.chunk)
    nk = fa.KEY_TILE // pl.key_groups
    keys = []
    for t0 in range(lo, hi, fa.KEY_TILE):
        keys += [c for c in range(t0 + group * nk, t0 + (group + 1) * nk)
                 if c < hi]
    return keys


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", KEY_GROUP_CASES)
def test_flash_decode_key_groups(B, Hq, Hkv, Sq, Skv, D):
    """At the one-row decode the warps of a block split its keys: the plan
    (a pure function of the shapes) gives every warp of a block a (row,
    key group), and each key of the cache is scored by exactly one
    (split, group)."""
    assert list(inspect.signature(fa.plan).parameters) == [
        "B", "Hq", "Hkv", "Sq", "Skv", "D", "dtype", "kv_dtype"]
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, torch.float32)
    assert pl == fa.plan(B, Hq, Hkv, Sq, Skv, D, torch.float32)
    packed = (Hq // Hkv) * Sq
    assert pl.path == "f32_rows" and pl.rows >= packed
    assert pl.rows * pl.key_groups == fa.F32_WARPS   # every warp busy
    warps = {(w % pl.rows, w // pl.rows) for w in range(fa.F32_WARPS)}
    assert len(warps) == fa.F32_WARPS                # one (row, group) each
    seen = torch.zeros(Skv, dtype=torch.int64)
    for split in range(pl.splits):
        for group in range(pl.key_groups):
            seen[_group_keys(pl, Skv, split, group)] += 1
    assert bool((seen == 1).all())
    assert pl.smem_bytes == 4 * (pl.rows * D + 2 * fa.KEY_TILE
                                 * (2 * D + 4 * pl.key_groups))


def _state(q, k, v, mask, keys, softcap):
    """(m, l, acc) of the online softmax over ``keys`` (m = -1e30, l = 0,
    acc = 0 where none is valid), as a warp group ends its stages."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q * D ** -0.5, k[:, :, keys])
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ms = mask[:, keys]
    m = torch.where(ms, s, torch.full_like(s, -1e30)).amax(-1)
    p = torch.where(ms, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, keys])


def _merge(parts):
    """Merge (m, l, acc) states in the order given."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    return mx, l, acc


@pytest.mark.parametrize("opts", [dict(kv_offset=299),
                                  dict(kv_offset=299, window=70, softcap=4.),
                                  dict(kv_offset=100), dict(kv_offset=-1)])
def test_key_group_merge_matches_attention_ref(opts):
    """The one-row decode at G = 1 as the rows kernel computes it: each
    warp group's (m, l, acc) over its keys of every stage, merged in warp
    order within a split, then the splits in split order; against
    ``attention_ref``, and exactly 0 where every key is masked."""
    B, H, Skv, D = 2, 4, 300, 96
    pl = fa.plan(B, H, H, 1, Skv, D, torch.float32)
    assert pl.key_groups == 8 and pl.splits > 1
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((B, H, 1, D), (B, H, Skv, D), (B, H, Skv, D)))
    pos = torch.arange(1)[:, None] + opts["kv_offset"]
    cols = torch.arange(Skv)[None, :]
    mask = cols <= pos
    if opts.get("window"):
        mask &= cols > pos - opts["window"]
    splits = []
    for split in range(pl.splits):
        groups = []
        for g in range(pl.key_groups):               # warp order
            keys = _group_keys(pl, Skv, split, g)
            if keys:
                groups.append(_state(q, k, v, mask, keys,
                                     opts.get("softcap", 0.0)))
        splits.append(_merge(groups))
    _, l, acc = _merge(splits)
    got = acc / torch.clamp(l, min=1e-30)[..., None]
    ref = fa.attention_ref(q, k, v, causal=True, **opts)
    if opts["kv_offset"] < 0:
        assert bool((got == 0).all()) and bool((ref == 0).all())
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


# (B, Hq, Hkv, Sq, Skv, dtype) at D = 256 -> (path, rows, key groups,
# shared memory)
HEAD_DIM_256 = [
    ((4, 16, 8, 4200, 4200, torch.bfloat16), ("bf16", 64, 1, 168960)),
    ((1, 16, 8, 4100, 4100, torch.float32), ("f32_mma", 64, 1, 200704)),
    ((1, 10, 1, 2100, 2100, torch.float32), ("f32_mma", 64, 1, 200704)),
    ((1, 16, 8, 8, 8, torch.float32), ("f32_mma", 64, 1, 200704)),
    ((1, 16, 8, 7, 7, torch.float32), ("f32_rows", 16, 1, 148480)),
    ((4, 10, 1, 1, 2048, torch.float32), ("f32_rows", 16, 1, 148480)),
    ((4, 16, 8, 1, 4207, torch.float32), ("f32_rows", 2, 4, 137216)),
    ((4, 16, 16, 1, 4090, torch.float32), ("f32_rows", 1, 8, 140288))]


@pytest.mark.parametrize("shape,want", HEAD_DIM_256,
                         ids=[f"{s[3]}x{s[4]}-g{s[1] // s[2]}-"
                              f"{str(s[5]).split('.')[-1]}"
                              for s, _ in HEAD_DIM_256])
def test_flash_plan_head_dim_256(shape, want):
    """All three kernels at D = 256: bf16 2 x 5 x 64 x 264 bytes; the
    float32 tensor-core prefill from 16 packed rows, 4 x (64 x 260 + 2 x
    32 x 524) bytes; the rows kernel below 16, 4 x (rows x 256 + 2 x 32 x
    (512 + 4 key groups)) bytes (197,632 at its most, 64 rows; 140,288 at
    one row and 8 key groups).  recurrentgemma's G = 10 one-row decode
    packs its 10 rows into one tile of 16 and splits the keys instead of
    halving the tile."""
    B, Hq, Hkv, Sq, Skv, dtype = shape
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, 256, dtype)
    assert (pl.path, pl.rows, pl.key_groups, pl.smem_bytes) == want
    assert pl.smem_bytes <= 4 * (64 * 256 + 2 * 32 * 516) == 197632 \
        or pl.path != "f32_rows"
    assert max(168960, 200704, 197632) <= bcf.MAX_SMEM
    if (Hq // Hkv, Sq) == (10, 1):
        assert pl.splits > 1 and pl.blocks >= 128


@pytest.mark.parametrize("Sq,want", [
    (16, ("f32_mma", 64, 256, 200704)),
    (2048, ("f32_mma", 64, 256, 200704)),
    (1, ("f32_rows", 4, 192, 4 * (4 * 192 + 2 * 32 * (2 * 192 + 4 * 2))))])
def test_flash_plan_refuses_float32_head_dim_192(Sq, want):
    """D = 192 under float32: from 16 packed rows the tensor-core prefill
    in the 256 tile (4 x (64 x 260 + 2 x 32 x 524) bytes, as at D = 256),
    one block per 64 packed rows; the one-row decode on the rows kernel
    at D itself (4 packed rows of G = 4, 2 key groups)."""
    B, Hq, Hkv, Skv = 2, 16, 4, 4096
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, 192, torch.float32)
    assert (pl.path, pl.rows, pl.tile, pl.smem_bytes) == want
    if pl.path == "f32_mma":
        assert pl.blocks == -(-4 * Sq // 64) * B * Hkv and pl.splits == 1
    assert pl.smem_bytes <= bcf.MAX_SMEM
    # the e4m3 lane reads a cache: the rows kernel at any rows
    e4 = fa.plan(B, Hq, Hkv, Sq, Skv, 192, torch.float32, fa.E4M3)
    assert (e4.path, e4.tile) == ("f32_rows", 192)


@pytest.mark.parametrize("D,tile", [(80, 96), (1, 32), (32, 32), (33, 64),
                                    (100, 128), (129, 256), (200, 256)])
def test_flash_plan_refuses_untiled_bf16_head_dim(D, tile):
    """The bf16 lane runs any D in the smallest tensor-core tile of 32,
    64, 96, 128 and 256 that holds it: shared memory follows the tile,
    the grid the shapes."""
    pl = fa.plan(1, 8, 2, 16, 16, D, torch.bfloat16)
    assert (pl.path, pl.tile, pl.rows, pl.splits, pl.blocks) == \
        ("bf16", tile, 64, 1, 8)
    assert pl.smem_bytes == 2 * 5 * 64 * (tile + 8)


@pytest.mark.parametrize("D,smem", [(64, 46080), (96, 66560), (128, 87040),
                                    (192, 168960), (256, 168960),
                                    (32, 25600)])
def test_flash_plan_bf16_head_dims(D, smem):
    """The bf16 lane tiles with Q and two K/V buffers of 64 rows padded
    to the tile + 8 values (2 x 5 x 64 x (tile + 8) bytes; at 256 within
    the 232,448 a block may use, one block an SM); 192 runs in the 256
    tile, the smoke configs' 32 in its own."""
    pl = fa.plan(1, 32, 32, 768, 768, D, torch.bfloat16)
    assert pl.smem_bytes == smem == 2 * 5 * fa.BF16_ROWS * (pl.tile + 8)
    assert (pl.rows, pl.splits, pl.blocks) == (64, 1, 12 * 32)


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.bfloat16, None), (torch.float32, None),
    (torch.float32, torch.float8_e4m3fn)])
@pytest.mark.parametrize("Sq", [1, 64])
def test_flash_plan_every_head_dim(dtype, kv_dtype, Sq):
    """A plan for every D from 1 to 256 (a multiple of 4 under e4m3 K/V)
    on every lane; the work and the launch's shape keep the real D."""
    for D in range(4 if kv_dtype else 1, 257, 4 if kv_dtype else 1):
        pl = fa.plan(2, 8, 2, Sq, 300, D, dtype, kv_dtype)
        assert pl.tile >= D and pl.smem_bytes <= bcf.MAX_SMEM
        w = fa.work(2, 8, 2, Sq, 300, D, dtype, kv_dtype)
        assert w.flops == 4 * D * 2 * 8 * fa.pairs(Sq, 300, kv_offset=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_plan_refuses_head_dim_257(dtype):
    """Above 256 every lane raises, naming the ROADMAP item."""
    with pytest.raises(ValueError, match=r"head dim 257.*ROADMAP B\.18"):
        fa.plan(1, 8, 2, 16, 16, 257, dtype)


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


# ---------------------------------------------------------------------------
# paged_attention: the plan and the page-range split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("maxp", [1, 5, 16])
@pytest.mark.parametrize("B", [1, 4, 8, 64])
@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_paged_plan(arch, B, maxp, page):
    Hq, Hkv, D = _heads(arch)
    assert "positions" not in inspect.signature(pa.plan).parameters
    for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
        pl = pa.plan(B, Hq, Hkv, D, page, maxp, kv_dtype)
        covered = torch.zeros(maxp, dtype=torch.int64)
        for s in range(pl.splits):              # the kernel's page ranges
            first = s * pl.pages_per_split
            assert first < maxp                  # no empty split
            covered[first:first + pl.pages_per_split] += 1
        assert bool((covered == 1).all())
        assert pl.smem_bytes <= bcf.MAX_SMEM == 232448
        assert pl.blocks == B * Hkv * pl.splits
        G = Hq // Hkv
        assert pl.warps in (4, 8) and G <= pl.warps * 4
        assert pl.warps >= min(G, 8)             # a warp per row up to 8
        if B * Hkv >= pa.SMS:                    # the card is already full
            assert pl.splits == 1
        else:                                    # about one wave, no more
            assert pl.blocks <= pa.SMS
    if B == 8 and maxp == 16 and arch in ARCHS:  # the serve phases' shape
        want = {"tinyllama-1.1b": (4, 4), "qwen2.5-3b": (8, 2),
                "qwen3-4b": (2, 8)}[arch]
        assert (pl.splits, pl.pages_per_split) == want


# (B, Hq, Hkv, D, maxp, kv dtype) -> (group tiles, warps, splits, pages a
# split, blocks, shared memory)
WIDE_PAGED_PLANS = [
    ((8, 8, 1, 256, 64, torch.float32),
     (1, 8, 16, 4, 128, 4 * (8 * 256 + 2 * 32 * 516) + 4 * 4)),
    ((8, 8, 1, 256, 64, torch.int8),
     (1, 8, 16, 4, 128, 4 * (8 * 256 + 2 * 32 * 516) + 3 * 4 * 4)),
    ((8, 71, 1, 64, 64, torch.float32),
     (5, 8, 3, 22, 120, 4 * (16 * 64 + 2 * 32 * 132) + 4 * 22)),
    ((8, 71, 1, 64, 64, torch.int8),
     (5, 8, 3, 22, 120, 4 * (16 * 64 + 2 * 32 * 132) + 3 * 4 * 22)),
    ((1, 2, 1, 200, 3, torch.bfloat16),
     (1, 8, 3, 1, 3, 4 * (2 * 256 + 2 * 32 * 516) + 4 * 1))]


@pytest.mark.parametrize("shape,want", WIDE_PAGED_PLANS,
                         ids=[f"d{s[3]}-g{s[1] // s[2]}-"
                              f"{str(s[5]).split('.')[-1]}"
                              for s, _ in WIDE_PAGED_PLANS])
def test_paged_plan_wide_and_grouped(shape, want):
    """D > 128 in the 256 tile on 8 warps; G = 71 in ceil(71 / 16) = 5
    group tiles of 16 rows at most, each a block of its own, counted in
    the grid and in the split rule (132 // (8 x 5) = 3 ranges of 22
    pages)."""
    B, Hq, Hkv, D, maxp, kv = shape
    pl = pa.plan(B, Hq, Hkv, D, 16, maxp, kv)
    assert (pl.group_tiles, pl.warps, pl.splits, pl.pages_per_split,
            pl.blocks, pl.smem_bytes) == want
    assert pl.blocks == B * Hkv * pl.group_tiles * pl.splits <= pa.SMS
    assert pl.smem_bytes <= bcf.MAX_SMEM


def test_paged_plan_refuses_head_dim_257():
    with pytest.raises(ValueError, match=r"head dim 257.*ROADMAP B\.18"):
        pa.plan(8, 8, 1, 257, 16, 64, torch.float32)


def _split_paged(q, pool_k, pool_v, table, positions, pps, softcap=0.0,
                 k_scale=None, v_scale=None):
    """paged attention as the kernel computes it: each split of ``pps``
    whole pages gives its (m, l, acc) over its valid keys (a split whose
    first column lies past the position does nothing); the live splits
    merge in split order; a slot with none is exactly 0."""
    _, page, Hkv, D = pool_k.shape
    B, maxp = table.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qh = q.reshape(B, Hkv, G, D).float() * D ** -0.5
    out = torch.zeros((B, Hkv, G, D))
    for b in range(B):
        ncols = min(int(positions[b]) + 1, maxp * page)
        parts = []
        for s in range(-(-maxp // pps)):
            c0 = s * pps * page
            c1 = min(ncols, c0 + pps * page)
            if c0 >= ncols:
                continue
            cols = torch.arange(c0, c1)
            pids = table[b, cols // page].long()
            kc = pool_k[pids, cols % page].float()            # (n, Hkv, D)
            vc = pool_v[pids, cols % page].float()
            if k_scale is not None:
                kc = kc * k_scale[pids][:, :, None]
                vc = vc * v_scale[pids][:, :, None]
            sc = torch.einsum("hgd,khd->hgk", qh[b], kc)
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgk,khd->hgd", p, vc)))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = acc / l[..., None]
    return out.reshape(B, Hq, D)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 3.0])
def test_split_paged_matches_stream(softcap, int8):
    Hq, Hkv, D, page, maxp, B = 32, 4, 64, 16, 16, 8
    pl = pa.plan(B, Hq, Hkv, D, page, maxp, torch.int8 if int8 else
                 torch.float32)
    assert pl.splits > 1
    rng = np.random.RandomState(2)
    P = B * maxp + 1
    pool_k, pool_v = (torch.from_numpy(rng.randn(P, page, Hkv, D)
                                       .astype(np.float32))
                      for _ in range(2))
    scales = {}
    if int8:
        pool_k, ks = codec.quantize_page_block(pool_k)
        pool_v, vs = codec.quantize_page_block(pool_v)
        scales = {"k_scale": ks, "v_scale": vs}
    table = torch.from_numpy((rng.permutation(P - 1)[:B * maxp] + 1)
                             .reshape(B, maxp).astype(np.int32))
    last = maxp * page - 1
    # idle, first column, a page's last and first column, a split's last
    # column, the table's last column, past it, and a middle one
    span = pl.pages_per_split * page
    positions = torch.tensor([-1, 0, page - 1, page, span - 1, last,
                              last + 7, 100], dtype=torch.int32)
    q = torch.from_numpy(rng.randn(B, Hq, D).astype(np.float32))
    got = _split_paged(q, pool_k, pool_v, table, positions,
                       pl.pages_per_split, softcap, **scales)
    ref = pa.paged_attention_stream(q, pool_k, pool_v, table, positions,
                                    softcap=softcap, **scales)
    assert bool((got[0] == 0).all()) and bool((ref[0] == 0).all())
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    idle = torch.full((B,), -1, dtype=torch.int32)   # an all-idle batch
    got = _split_paged(q, pool_k, pool_v, table, idle, pl.pages_per_split,
                       softcap, **scales)
    assert bool((got == 0).all())


# ---------------------------------------------------------------------------
# spectral_matmul
# ---------------------------------------------------------------------------
def _spectral_shapes():
    """(Q, P) of every distinct batch-prefill projection of the three
    archs (q = input blocks, p = output blocks): 11 shapes."""
    return sorted({(q, p) for _, _, p, q, _ in _block_shapes(ARCHS)})


def _new_spectral_shapes():
    """(Q, P) of the batch-prefill projections phi-3-vision and llama4
    add (llama4's experts take ``bc_fused``, not the hook)."""
    return sorted({(q, p) for _, _, p, q, _ in _block_shapes(NEW_ARCHS)}
                  - set(_spectral_shapes()))


# the 11 batch-prefill shapes at F = 65, N = 2048, the card test's small
# ragged ones, then the new archs' at their serve prefills' rows
SPECTRAL_CASES = ([(65, 2048, q, p) for q, p in _spectral_shapes()]
                  + [(9, 37, 8, 16), (65, 100, 16, 2), (65, 70, 44, 16),
                     (65, 33, 16, 44), (65, 20, 86, 16), (65, 21, 20, 76)]
                  + [(65, 3040, q, p) for q, p in _new_spectral_shapes()])


def _spectral_coverage(pl, F, N, P):
    """The kernel's indexing replayed on the host: ``out[f, n, p]`` counts
    the warp units that write output (f, n, p).  Blocks (chunk c, split s)
    take bins [c F / chunks, (c + 1) F / chunks) and row tiles s,
    s + splits, ...;
    each tile's units are (bin, 16-row mma tile, group of jn 8-column
    tiles)."""
    out = np.zeros((F, N, P), np.int16)
    tiles = -(-N // pl.rows)
    rows = np.zeros(N, np.int16)
    for s in range(pl.splits):
        for t in range(s, tiles, pl.splits):
            rows[t * pl.rows:(t + 1) * pl.rows] += 1
    nt = smm.pad8(P) // 8
    for c in range(pl.chunks):
        bins = range(c * F // pl.chunks, (c + 1) * F // pl.chunks)
        assert 1 <= len(bins) <= pl.fc
        for nt0 in range(0, nt, pl.jn):
            cols = slice(nt0 * 8, min(P, (nt0 + min(pl.jn, nt - nt0)) * 8))
            out[bins.start:bins.stop, :, cols] += rows[None, :, None]
    return out


@pytest.mark.parametrize("layout", [smm.BIN_MAJOR, smm.BIN_MINOR],
                         ids=["bin_major", "bin_minor"])
@pytest.mark.parametrize("F,N,Q,P", SPECTRAL_CASES)
def test_spectral_plan(F, N, Q, P, layout):
    pl = smm.plan(F, N, Q, P, layout)
    assert len(_spectral_shapes()) == 11
    assert pl.layout == layout and pl.path == "mma_3xtf32"
    assert pl.smem_bytes <= smm.MAX_SMEM == 232448
    assert pl.per_sm * (pl.smem_bytes + smm.SMEM_RESERVED) <= smm.SM_SMEM
    # what csrc/spectral_matmul.cu:spectral_matmul accepts
    assert pl.fc in smm.FCS and pl.stages in (2, 3)
    assert pl.smem_bytes == smm.smem_bytes(Q, P, layout, pl.fc, pl.rows,
                                           pl.stages)
    assert 1 <= pl.jn <= smm.MAX_J and pl.p_tile == 8 * pl.jn
    assert 1 <= pl.chunks <= F and -(-F // pl.chunks) <= pl.fc
    assert pl.rows in smm.ROWS
    assert 1 <= pl.splits <= min(smm.MAX_GRID_Y, -(-N // pl.rows))
    assert pl.grid == (pl.chunks, pl.splits) and pl.block == 256
    # one wave of blocks: every block is resident at once
    assert pl.chunks * pl.splits <= smm.SMS * pl.per_sm or pl.splits == 1
    # Q and P padded with zeros to the mma's multiples of 8
    for n in (Q, P):
        assert smm.pad8(n) % 8 == 0 and n <= smm.pad8(n) < n + 8
    out = _spectral_coverage(pl, F, N, P)
    assert bool((out == 1).all()), "an output is written 0 or 2+ times"


GEMMA_SPECTRAL = sorted({(q, p) for _, _, p, q, _ in GEMMA_SHAPES})


@pytest.mark.parametrize("layout", [smm.BIN_MAJOR, smm.BIN_MINOR],
                         ids=["bin_major", "bin_minor"])
@pytest.mark.parametrize("Q,P", GEMMA_SPECTRAL)
def test_spectral_plan_gemma_shapes(Q, P, layout):
    """The batch-prefill shapes gemma2 and recurrentgemma bring (Q = 28 or
    20 input blocks; P up to 112), at 3,040 rows: the same properties."""
    test_spectral_plan(65, 3040, Q, P, layout)


@pytest.mark.parametrize("layout", [smm.BIN_MAJOR, smm.BIN_MINOR])
def test_spectral_plan_refuses(layout):
    with pytest.raises(ValueError, match="no launch plan"):
        smm.plan(65, 2048, 1000, 2, layout)     # Q beyond shared memory
    with pytest.raises(ValueError, match="empty shape"):
        smm.plan(65, 0, 16, 16, layout)
    with pytest.raises(ValueError, match="layout"):
        smm.plan(65, 2048, 16, 16, 2)


def _mma_product(a, b):
    """a @ b as the spectral kernel forms it: K padded with zeros to a
    multiple of 8; per mma (8 terms of K, summed in order in float32)
    lo*hi and hi*lo go into one float32 sum and hi*hi into another, added
    at the end (csrc/spectral_matmul.cu)."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    K = a.shape[1]
    pad = -K % 8
    a, b = np.pad(a, ((0, 0), (0, pad))), np.pad(b, ((0, pad), (0, 0)))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    hh = np.zeros((a.shape[0], b.shape[1]), np.float32)
    lo = np.zeros_like(hh)

    def mma(x, y, k0):
        s = np.zeros_like(hh)
        for kk in range(k0, k0 + 8):
            s += np.outer(x[:, kk], y[kk]).astype(np.float32)
        return s

    for k0 in range(0, K + pad, 8):
        lo += mma(al, bh, k0)
        lo += mma(ah, bl, k0)
        hh += mma(ah, bh, k0)
    return hh + lo


def test_3xtf32_gauss_mac_keeps_float32_accuracy():
    """The Gauss MAC at qwen2.5's down projection (Q = 86, P = 16) in
    3xTF32, against float64, beside float32 FMAs in order."""
    rng = np.random.RandomState(0)
    N, Q, P = 64, 86, 16
    xr, xi = (rng.randn(N, Q).astype(np.float32) for _ in range(2))
    wr, ws1, ws2 = ((rng.randn(Q, P) * Q ** -0.5).astype(np.float32)
                    for _ in range(3))
    xs = xr + xi                                  # float32, as the kernel
    d = lambda a: a.astype(np.float64)            # noqa: E731
    t1 = d(xs) @ d(wr)
    ref = (t1 - d(xi) @ d(ws2), t1 + d(xr) @ d(ws1))
    scale = max(float(np.abs(r).max()) for r in ref)
    err = {}
    for mode, prod in (("f32", lambda a, b: _product(a, b, "f32")),
                       ("3xtf32", _mma_product)):
        t1, t2, t3 = prod(xs, wr), prod(xr, ws1), prod(xi, ws2)
        err[mode] = max(float(np.abs(t1 - t3 - ref[0]).max()),
                        float(np.abs(t1 + t2 - ref[1]).max()))
    print(f"Gauss MAC Q=86, max abs error (output scale {scale:.3f}): {err}")
    assert err["3xtf32"] <= 2 * err["f32"]
    assert err["3xtf32"] <= 1e-5 * scale


def _split_alu(a):
    """csrc/mma_tf32.cuh:split_tf32_alu: hi rounds to nearest, ties away
    (``_tf32``); lo = a - hi exactly, of which the tensor cores read the
    top 19 bits (truncated toward zero)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    hi = _tf32(a)
    lo = (a - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def _mma3(a, b):
    """a @ b as the float32 tensor-core flash kernel forms it: per mma of
    8 terms of K (summed in float32), lo*hi, hi*lo and hi*hi in that
    order into one float32 accumulator."""
    ah, al = _split_alu(a)
    bh, bl = _split_alu(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc += np.einsum("mk,kn->mn", x[:, k0:k0 + 8],
                             y[k0:k0 + 8]).astype(np.float32)
    return acc


@pytest.mark.parametrize("D", [64, 96, 128])
def test_3xtf32_flash_tile_keeps_float32_accuracy(D):
    """One warp's tile of the float32 tensor-core prefill: 16 query rows
    against 32 keys, Q K^T in 3xTF32, the softmax in float32, P V in
    3xTF32; against float64 within 1e-4 of the output's scale (one TF32
    product, beside it, misses that)."""
    rng = np.random.RandomState(D)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((16, D), (32, D), (32, D)))
    scale = D ** -0.5
    d = lambda a: a.astype(np.float64)               # noqa: E731
    s64 = d(q) @ d(k).T * scale
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    ref = (p64 / p64.sum(-1, keepdims=True)) @ d(v)

    def tile(prod):
        s = prod(q, k.T) * np.float32(scale)
        p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
        return prod(p, v) / p.sum(-1, keepdims=True)

    out_scale = max(1.0, float(np.abs(ref).max()))
    err = {"3xtf32": float(np.abs(tile(_mma3) - ref).max()),
           "tf32": float(np.abs(tile(lambda a, b: _product(a, b, "tf32"))
                                - ref).max())}
    print(f"flash tile D={D}, max abs error (scale {out_scale:.3f}): {err}")
    assert err["3xtf32"] <= 1e-5 * out_scale    # well inside 1e-4
    assert err["tf32"] > 1e-4 * out_scale       # the reason for the split
