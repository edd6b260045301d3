"""Flash-attention forward: causal, sliding window, softcap, GQA,
``kv_offset``; prefill, and the batch engine's one-row decode.

Port of ``repro/kernels/flash_attention.py`` and of its reference
``repro/kernels/ref.py:attention_ref``.  ``flash_attention`` is the wrapper:
on CUDA tensors it launches ``csrc/flash_attention.cu`` (or raises), on CPU
tensors it runs ``attention_ref``.  Layout (B, H, S, D), as in ``repro``.

Two lanes: bf16 on the tensor cores (head dims 64 and 128), float32 on the
CUDA cores with the G query heads of a KV head packed into one block and,
where that grid is small (decode), the keys split over blocks and merged
in the same call.  ``plan`` picks the split from the shapes alone.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .build import Kernel, check_cuda, ptr

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("flash_attention", {
    "flash_attention": [_VP] * 5 + [_I] * 6 + [_F, _I, _I, _F, _I, _I, _I,
                                               _I, _I]})

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
BF16_HEAD_DIMS = (64, 128)   # the bf16 lane's tensor-core tilings
SMS = 132                    # streaming multiprocessors of an H100
BF16_ROWS, F32_ROWS, KEY_TILE = 64, 64, 32   # csrc kBQ, kF32MaxRows, kTile
F32_MIN_ROWS = 8                             # one packed row a warp


class FlashPlan(NamedTuple):
    """``rows`` (packed) query rows a block; ``splits`` key ranges of
    ``chunk`` keys each (float32 lane; 1 for bf16); the grid's ``blocks``
    and each block's ``smem_bytes``."""
    dtype: torch.dtype
    rows: int
    splits: int
    chunk: int
    blocks: int
    smem_bytes: int


def plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
         dtype: torch.dtype) -> FlashPlan:
    """The launch plan, a pure function of the shapes.  bf16: one block
    per (batch, query head, 64 rows).  float32: one block per (batch, KV
    head, tile of packed rows, G heads x Sq positions); a tile holds up to
    64 packed rows, halved (down to 8, one a warp) while the grid would
    not fill the SMs.  Where all of a KV head's rows fit one tile and the
    grid still would not fill them, the keys are split into ranges of a
    multiple of 32 keys, enough ranges to reach about SMS blocks."""
    if dtype == torch.bfloat16:
        if D not in BF16_HEAD_DIMS:
            raise ValueError(f"flash_attention: the bf16 lane tiles head "
                             f"dims {BF16_HEAD_DIMS} on the tensor cores, "
                             f"not {D}")
        return FlashPlan(dtype, BF16_ROWS, 1, max(Skv, 1),
                         -(-Sq // BF16_ROWS) * Hq * B,
                         2 * 5 * BF16_ROWS * (D + 8))
    packed = (Hq // Hkv) * Sq
    rows = F32_ROWS
    while rows > F32_MIN_ROWS and rows // 2 >= packed:
        rows //= 2                          # no wider than the rows there are
    while rows > F32_MIN_ROWS and -(-packed // rows) * B * Hkv < SMS:
        rows //= 2                          # more blocks
    base = -(-packed // rows) * B * Hkv
    splits, chunk = 1, max(Skv, 1)
    if packed <= rows and base < SMS and Skv > KEY_TILE:
        want = min(-(-SMS // base), -(-Skv // KEY_TILE))
        chunk = -(-(-(-Skv // want)) // KEY_TILE) * KEY_TILE
        splits = -(-Skv // chunk)
    return FlashPlan(dtype, rows, splits, chunk, base * splits,
                     4 * (rows * D + KEY_TILE * (2 * D + 4)))


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=None, kv_offset=0):
    """Plain version: full-materialization softmax attention.
    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  ``kv_offset`` is the absolute
    position of q[0] minus that of k[0].  Fully masked rows give 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
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
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q.dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             kv_offset=kv_offset)
    dts = tuple(DTYPE_CODES)
    device = check_cuda("flash_attention", {"q": q, "k": k, "v": v},
                        {"q": dts, "k": dts, "v": dts})
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v must share one dtype")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    pl = plan(B, Hq, Hkv, Sq, Skv, D, q.dtype)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    part = None                       # the splits' (m, l) and acc
    if pl.splits > 1:
        part = torch.empty(pl.splits * B * Hq * Sq * (D + 2), device=device,
                           dtype=torch.float32)
    KERNEL.launch("flash_attention", device, ptr(q), ptr(k), ptr(v), ptr(o),
                  ctypes.c_void_p(None if part is None else part.data_ptr()),
                  B, Hq, Hkv, Sq, Skv, D, float(scale), int(bool(causal)),
                  int(window), float(softcap), int(kv_offset),
                  DTYPE_CODES[q.dtype], pl.rows, pl.splits, pl.chunk)
    return o
