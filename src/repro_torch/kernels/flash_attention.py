"""Flash-attention forward: causal, sliding window, softcap, GQA,
``kv_offset``; prefill, and the batch engine's one-row decode.

Port of ``repro/kernels/flash_attention.py`` and of its reference
``repro/kernels/ref.py:attention_ref``.  ``flash_attention`` is the wrapper:
on CUDA tensors it launches ``csrc/flash_attention.cu`` (or raises), on CPU
tensors it runs ``attention_ref``.  Layout (B, H, S, D), as in ``repro``.

Three kernels, one ``path`` each in the plan: ``bf16`` on the tensor cores
(any head dim up to 256, in the smallest tile of 32, 64, 96, 128 and 256
that holds it); ``f32_mma``, the float32 prefill (16 packed rows or more)
on the tensor cores in 3xTF32 at D = 64, 96, 128 and any D above 128 (in
the 256 tile); ``f32_rows``, float32 on the CUDA cores (the one-row
decode, the other head dims up to 128), with the G query heads of a KV
head packed into one block, the warps of a block splitting the keys where
it holds fewer rows than warps, and, where the grid is small, the keys
split over blocks and merged in the same call.  ``plan`` picks the kernel,
the tile and the splits from the shapes alone.  A tile wider than the
head dim holds zeros past it, and only D columns are stored.  A head dim
above 256 raises (ROADMAP B.18).

K and V share q's dtype, or, under a float32 q, are ``float8_e4m3fn`` (a
dense cache of ``kv_cache_dtype="float8_e4m3fn"``): the rows kernel then
reads them as e4m3 and widens them as it stages them, exactly, at any
number of rows (``plan(..., kv_dtype=)``; its launches count under the path
``f32_rows_e4m3``).  Only decode reads a cache, as in ``repro``, so the
tensor-core prefill has no e4m3 instance.  The plain version is
``attention_ref`` on K and V widened to float32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .build import Kernel, Work, address, check_cuda, on_cpu, ptr

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("flash_attention", {
    "flash_attention": [_VP] * 5 + [_I] * 6 + [_F, _I, _I, _F, _I, _I, _I,
                                               _I, _I, _I, _I]})

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K/V dtypes: q's own, or e4m3 under a float32 q (the float32 kernels)
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
E4M3 = torch.float8_e4m3fn
RUN_TIME_MAX_HEAD_DIM = 128  # csrc attn::kMaxD: 4 dims a lane up to it
MAX_HEAD_DIM = 256           # csrc kWideD: every kernel takes D up to it
BF16_TILES = (32, 64, 96, 128, 256)   # the bf16 lane's tensor-core tiles
SMS = 132                    # streaming multiprocessors of an H100
BF16_ROWS, F32_ROWS, KEY_TILE = 64, 64, 32   # csrc kBQ, kF32MaxRows, kTile
F32_WARPS = 8                                # csrc kF32Warps
F32_MMA_HEAD_DIMS = (64, 96, 128, 256)       # the f32 tensor-core tiles
F32_MMA_ROWS, F32_MMA_KEYS = 64, 32          # csrc kFR, kFK
F32_MMA_MIN_ROWS = 16                        # one m16 tile of packed rows


class FlashPlan(NamedTuple):
    """``rows`` (packed) query rows a block; ``splits`` key ranges of
    ``chunk`` keys each (the f32 rows kernel; 1 otherwise); the grid's
    ``blocks`` and each block's ``smem_bytes``; the kernel (``path``:
    ``bf16``, ``f32_mma`` or ``f32_rows``) and, for ``f32_rows``, the
    ``key_groups`` of warps that split a row's keys (8 // rows below 8
    rows, else 1); ``tile``, the head dim the kernel's shared memory holds
    (the tensor-core kernels' padded tile; D itself on ``f32_rows``)."""
    dtype: torch.dtype
    rows: int
    splits: int
    chunk: int
    blocks: int
    smem_bytes: int
    path: str
    key_groups: int
    tile: int


def tile_for(D: int, tiles: Sequence[int]) -> int:
    """The smallest tile that holds head dim D."""
    return next(t for t in tiles if t >= D)


def plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
         dtype: torch.dtype, kv_dtype: torch.dtype = None) -> FlashPlan:
    """The launch plan, a pure function of the shapes.  bf16: one block
    per (batch, query head, 64 rows).  float32 with at least 16 packed
    rows (G heads x Sq positions) at D = 64, 96, 128 or 256: the
    tensor-core prefill, one block per (batch, KV head, 64 packed rows).
    Other float32: the rows kernel, one block per (batch, KV head, tile of
    packed rows); a tile holds up to 64 packed rows, the smallest power of
    two that holds them all (down to 1: the warps then split the keys),
    halved down to 8 while the rows overflow it and the grid would not
    fill the SMs.  Where all of a KV head's rows fit one tile (G = 10 at
    one position: a tile of 16) and the grid still would not fill the SMs,
    the keys are split into ranges of a multiple of 32 keys, enough ranges
    to reach about SMS blocks: each block keeps all its warps busy (the key
    groups), so one block an SM fills the card.  The bf16 lane runs
    D in the smallest of ``BF16_TILES`` that holds it; the tensor-core
    prefill D = 64, 96, 128 in their own tiles and any D above 128 in the
    256 tile; the rows kernel any other D up to 256.  A head dim above 256
    raises.  An e4m3 ``kv_dtype`` takes the rows kernel at any rows."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D}: the kernels take "
                         f"1 to {MAX_HEAD_DIM}; a wider head is not ported "
                         f"(ROADMAP B.18)")
    if dtype == torch.bfloat16:
        dp = tile_for(D, BF16_TILES)
        return FlashPlan(dtype, BF16_ROWS, 1, max(Skv, 1),
                         -(-Sq // BF16_ROWS) * Hq * B,
                         2 * 5 * BF16_ROWS * (dp + 8), "bf16", 1, dp)
    packed = (Hq // Hkv) * Sq
    if ((D in F32_MMA_HEAD_DIMS or D > RUN_TIME_MAX_HEAD_DIM)
            and packed >= F32_MMA_MIN_ROWS and kv_dtype != E4M3):
        dp = tile_for(D, F32_MMA_HEAD_DIMS)
        return FlashPlan(dtype, F32_MMA_ROWS, 1, max(Skv, 1),
                         -(-packed // F32_MMA_ROWS) * B * Hkv,
                         4 * (F32_MMA_ROWS * (dp + 4)
                              + 2 * F32_MMA_KEYS * (2 * dp + 12)),
                         "f32_mma", 1, dp)
    rows = F32_ROWS
    while rows > 1 and rows // 2 >= packed:
        rows //= 2                          # no wider than the rows there are
    while (rows > F32_WARPS and packed > rows
           and -(-packed // rows) * B * Hkv < SMS):
        rows //= 2                          # more blocks
    groups = max(1, F32_WARPS // rows)
    base = -(-packed // rows) * B * Hkv
    splits, chunk = 1, max(Skv, 1)
    if packed <= rows and base < SMS and Skv > KEY_TILE:
        want = min(-(-SMS // base), -(-Skv // KEY_TILE))
        chunk = -(-(-(-Skv // want)) // KEY_TILE) * KEY_TILE
        splits = -(-Skv // chunk)
    return FlashPlan(dtype, rows, splits, chunk, base * splits,
                     4 * (rows * D + 2 * KEY_TILE * (2 * D + 4 * groups)),
                     "f32_rows", groups, D)


def shape_key(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, dtype,
              *, causal: bool, window: int = 0, kv_offset: int = 0,
              kv_dtype=None) -> str:
    """A launch's shape and mask as ``Kernel.shape_launches`` counts it
    (an e4m3 K/V adds ``/kv_float8_e4m3fn`` after the dtype)."""
    kv = ("" if kv_dtype in (None, dtype)
          else f"/kv_{str(kv_dtype).split('.')[-1]}")
    return (f"{B}x{Hq}x{Hkv}x{Sq}x{Skv}x{D}/{str(dtype).split('.')[-1]}{kv}/"
            f"{'causal' if causal else 'full'}/w{window}/off{kv_offset}")


def pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0,
          kv_offset: int = 0) -> int:
    """(query row, key) pairs the mask keeps: key c is seen by row r (at
    absolute position r + kv_offset) iff c <= r + kv_offset where
    ``causal`` and c > r + kv_offset - window where ``window``."""
    r = np.arange(Sq, dtype=np.int64) + kv_offset
    hi = np.minimum(r, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
         dtype: torch.dtype, kv_dtype: torch.dtype = None, *,
         causal: bool = True, window: int = 0, kv_offset: int = 0) -> Work:
    """What one launch does: 4 D operations a kept (query row, key) pair
    and head (QK^T and PV, a multiply and an add each); bytes are q read
    and o written at q's width and K/V read once at their stored width
    (their heads not repeated); the scratch is the split-KV partials
    (``(m, l)`` and the accumulator of each split, row and head, float32)
    where ``plan`` splits the keys."""
    kv_dtype = kv_dtype or dtype
    qi, ki = dtype.itemsize, kv_dtype.itemsize
    pl = plan(B, Hq, Hkv, Sq, Skv, D, dtype, kv_dtype)
    flops = 4 * D * B * Hq * pairs(Sq, Skv, causal=causal, window=window,
                                   kv_offset=kv_offset)
    nbytes = qi * 2 * B * Hq * Sq * D + ki * 2 * B * Hkv * Skv * D
    scratch = 4 * pl.splits * B * Hq * Sq * (D + 2) if pl.splits > 1 else 0
    return Work(float(flops), nbytes, scratch)


def launch_work(fn: str, ints: Sequence) -> Work:
    """``work`` of a launch from its scalar arguments (B, Hq, Hkv, Sq, Skv,
    D, scale, causal, window, softcap, kv_offset, the dtype codes, the
    plan): the stand-in's count (``kernels/standin.py``)."""
    B, Hq, Hkv, Sq, Skv, D, _, causal, window, _, off, dt, kvt = ints[:13]
    dtypes = {c: t for t, c in DTYPE_CODES.items()}
    kv_dtypes = {c: t for t, c in KV_CODES.items()}
    return work(B, Hq, Hkv, Sq, Skv, D, dtypes[dt], kv_dtypes[kvt],
                causal=bool(causal), window=window, kv_offset=off)


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=None, kv_offset=0):
    """Plain version: full-materialization softmax attention.
    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  ``kv_offset`` is the absolute
    position of q[0] minus that of k[0].  Fully masked rows give 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kk.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, kv_offset=0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q.dtype.
    k and v share q's dtype, or are float8_e4m3fn under a float32 q."""
    if on_cpu(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             kv_offset=kv_offset)
    dts, kvs = tuple(DTYPE_CODES), tuple(KV_CODES)
    device = check_cuda("flash_attention", {"q": q, "k": k, "v": v},
                        {"q": dts, "k": kvs, "v": kvs})
    e4m3 = k.dtype == E4M3
    if k.dtype != v.dtype or not (k.dtype == q.dtype or (
            e4m3 and q.dtype == torch.float32)):
        raise ValueError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}: k and v share q's dtype, or are "
                         f"float8_e4m3fn under a float32 q")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)}")
    pl = plan(B, Hq, Hkv, Sq, Skv, D, q.dtype, k.dtype)  # raises: D > 256
    if e4m3 and (D % 4 or (address(k) | address(v)) % 4):
        raise ValueError("flash_attention: an e4m3 K/V is read 4 values a "
                         "load: D a multiple of 4, k and v 4-byte aligned")
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    part = None                       # the splits' (m, l) and acc
    if pl.splits > 1:
        part = torch.empty(pl.splits * B * Hq * Sq * (D + 2), device=device,
                           dtype=torch.float32)
    KERNEL.launch("flash_attention", device, ptr(q), ptr(k), ptr(v), ptr(o),
                  ctypes.c_void_p(None if part is None else address(part)),
                  B, Hq, Hkv, Sq, Skv, D, float(scale), int(bool(causal)),
                  int(window), float(softcap), int(kv_offset),
                  DTYPE_CODES[q.dtype], KV_CODES[k.dtype], pl.rows,
                  pl.splits, pl.chunk, int(pl.path == "f32_mma"),
                  path=pl.path + ("_e4m3" if e4m3 else ""),
                  shape=shape_key(B, Hq, Hkv, Sq, Skv, D, q.dtype,
                                  causal=bool(causal), window=int(window),
                                  kv_offset=int(kv_offset),
                                  kv_dtype=k.dtype))
    return o
