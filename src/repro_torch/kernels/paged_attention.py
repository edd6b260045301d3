"""Paged flash-decode: stream each slot's pool pages through the online-
softmax recurrence instead of materializing the gathered KV view.

Port of ``repro/kernels/paged_attention.py``.  ``paged_attention`` is the
wrapper: on CUDA tensors it launches ``csrc/paged_attention.cu`` (or
raises), on CPU tensors it runs ``paged_attention_stream``, the plain
version.  A key position ``i`` of slot ``b`` is valid iff
``i <= positions[b]``: that one predicate covers trash-page reads, the
partly filled last page, and idle slots (``positions == -1``, whose output
row is exactly zero).

An int8 pool (``k_scale``/``v_scale``, one float32 scale per (page, KV
head)) takes the kernel's int8 lane, ``paged_attention_i8``, which
dequantizes each code as it fills its shared-memory tile.

The kernel splits each slot's table into ranges of whole pages over
blocks and merges the ranges in the same call; ``plan`` picks the split
from the shapes alone (never from ``positions``), so a call can be
captured in a CUDA graph.  A block serves up to 16 query heads of one KV
head (a group of G heads takes ceil(G / 16) blocks, each reading the
slot's pages); a head dim up to 128 is its own tile width, one in (128,
256] runs in a tile of 256 with zeros past D.  A head dim above 256
raises (ROADMAP B.18).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .build import Kernel, Work, address, check_cuda, on_cpu, ptr

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("paged_attention", {
    "paged_attention": [_VP] * 7 + [_I] * 7 + [_F, _F] + [_I] * 5,
    "paged_attention_i8": [_VP] * 9 + [_I] * 7 + [_F, _F] + [_I] * 4})

_NEG = -1e30
BLOCK_PAGES = 4           # pages per step of the plain streamed loop
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WIDE_D = 128              # csrc attn::kMaxD: a wider head takes the 256 tile
MAX_GROUP = 16            # query heads of a KV head one CUDA block serves
SMS = 132                 # streaming multiprocessors of an H100
KEY_TILE = 32             # csrc attn::kTile
MAX_SPLIT_PAGES = 512     # page ids (and scales) a block stages


class PagedPlan(NamedTuple):
    """``splits`` ranges of ``pages_per_split`` whole pages of the table
    (the last may be shorter), ``warps`` warps a block, ``group_tiles``
    blocks a KV head (tiles of up to ``MAX_GROUP`` query heads); the
    grid's ``blocks`` (Hkv x group_tiles, B, splits) and each block's
    ``smem_bytes``."""
    splits: int
    pages_per_split: int
    warps: int
    blocks: int
    smem_bytes: int
    group_tiles: int


def plan(B: int, Hq: int, Hkv: int, D: int, page: int, maxp: int,
         kv_dtype: torch.dtype) -> PagedPlan:
    """The launch plan, a pure function of the shapes.  One block per
    (KV head, group tile, slot, split); the G = Hq / Hkv query heads of a
    KV head in ceil(G / 16) tiles of up to 16 (G = 71: 16, 16, 16, 16,
    7).  While B * Hkv * tiles blocks leave SMs idle, the table's maxp
    pages are split into SMS // (B * Hkv * tiles) ranges or fewer (never
    more blocks than one wave of SMs, never an empty range): at 8 slots
    and 16 pages, 4 ranges of 4 pages at 4 KV heads, 8 of 2 at 2, 2 of 8
    at 8.  One range where the blocks already fill the card, unless the
    table has more than ``MAX_SPLIT_PAGES`` pages.  4 warps, or 8 where a
    tile holds more than 4 heads or D > 128, so each of up to 8 query rows
    has its own warp.  Shared memory holds the tile's rows and two K/V
    tiles of 32 keys, D wide (256 where D > 128).  A head dim above 256
    raises."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {D}: the kernel takes "
                         f"1 to {MAX_HEAD_DIM}; a wider head is not ported "
                         f"(ROADMAP B.18)")
    G = Hq // Hkv
    tiles = -(-G // MAX_GROUP)
    rows = min(G, MAX_GROUP)
    want = max(1, min(maxp, SMS // (B * Hkv * tiles)))
    pps = min(-(-maxp // want), MAX_SPLIT_PAGES)
    splits = -(-maxp // pps)
    warps = 4 if rows <= 4 and D <= WIDE_D else 8
    width = D if D <= WIDE_D else MAX_HEAD_DIM
    stage = 4 * pps * (3 if kv_dtype == torch.int8 else 1)
    smem = 4 * (rows * width + 2 * KEY_TILE * (2 * width + 4)) + stage
    return PagedPlan(splits, pps, warps, B * Hkv * tiles * splits, smem,
                     tiles)


def work(B: int, Hq: int, Hkv: int, D: int, page: int, maxp: int,
         positions: Sequence[int], dtype: torch.dtype,
         pool_dtype: torch.dtype) -> Work:
    """What one launch does at ``positions`` (slot b reads positions[b] +
    1 keys; -1 is idle): 4 D operations a head and key read (QK^T and PV),
    and on an int8 pool 2 D more a KV head and key (a scale multiply of
    K and of V); bytes are q read and the output written at q's width,
    the keys read at the pool's width, an int8 pool's scales once a page
    read, the table and the positions; the scratch is the split ranges'
    partials (float32 ``(m, l)`` and accumulator a split, slot and head)
    where ``plan`` splits the table."""
    live = sum(p_ + 1 for p_ in positions if p_ >= 0)
    live_pages = sum((p_ + page) // page for p_ in positions if p_ >= 0)
    quant = pool_dtype == torch.int8
    pl = plan(B, Hq, Hkv, D, page, maxp, pool_dtype)
    nbytes = (2 * B * Hq * D * dtype.itemsize
              + 2 * live * Hkv * D * pool_dtype.itemsize
              + (2 * live_pages * Hkv * 4 if quant else 0)
              + B * maxp * 4 + B * 4)
    flops = 4 * Hq * D * live + (2 * live * Hkv * D if quant else 0)
    scratch = 4 * pl.splits * B * Hq * (D + 2) if pl.splits > 1 else 0
    return Work(float(flops), nbytes, scratch)


def launch_work(fn: str, ints: Sequence) -> Work:
    """``work`` of a launch from its scalar arguments (B, Hq, Hkv, D,
    page, maxp, P, scale, softcap, the dtype codes, the plan): the
    stand-in's count (``kernels/standin.py``).  A trace has no positions,
    so every slot counts as reading its whole table (position maxp x page
    - 1): the most the launch can read."""
    B, Hq, Hkv, D, page, maxp = ints[:6]
    dtypes = {c: t for t, c in DTYPE_CODES.items()}
    pool = (torch.int8 if fn == "paged_attention_i8"
            else dtypes[ints[10]])
    return work(B, Hq, Hkv, D, page, maxp, [maxp * page - 1] * B,
                dtypes[ints[9]], pool)


def paged_attention_stream(q, pool_k, pool_v, table, positions, *,
                           scale=None, softcap: float = 0.0,
                           block_pages: int = BLOCK_PAGES,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version.  q: (B, Hq, D); pool: (P, page, Hkv, D); table:
    (B, maxp) int32; positions: (B,) int32 (-1 = idle).  Returns
    (B, Hq, D) in q.dtype.  Loops over ``block_pages``-page chunks up to
    the longest live slot; ``k_scale``/``v_scale`` ((P, Hkv) float32)
    dequantize an int8 pool chunk by chunk."""
    _, page, Hkv, D = pool_k.shape
    B, maxp = table.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, Hkv, G, D).float() * scale
    table = table.long()

    bp = min(block_pages, maxp)
    n_blocks = -(-maxp // bp)
    if maxp % bp:
        table = torch.nn.functional.pad(table, (0, n_blocks * bp - maxp))
    n_live = max(int(positions.max()), -1) + 1
    live_blocks = min((n_live + bp * page - 1) // (bp * page), n_blocks)

    m = torch.full((B, Hkv, G), _NEG, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for j in range(live_blocks):
        pids = table[:, j * bp:(j + 1) * bp]                 # (B, bp)
        kc = pool_k[pids].float()                            # (B, bp, page, Hkv, D)
        vc = pool_v[pids].float()
        if k_scale is not None:
            kc = kc * k_scale[pids][:, :, None, :, None]
            vc = vc * v_scale[pids][:, :, None, :, None]
        kc = kc.reshape(B, bp * page, Hkv, D)
        vc = vc.reshape(B, bp * page, Hkv, D)
        s = torch.einsum("bhgd,bkhd->bhgk", qh, kc)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        cols = j * bp * page + torch.arange(bp * page, device=q.device)
        msk = (cols[None, :] <= positions[:, None])[:, None, None, :]
        s = torch.where(msk, s, torch.full_like(s, _NEG))
        m_n = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_n[..., None])
        p = torch.where(msk, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_n)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vc)
        m = m_n
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_attention(q, pool_k, pool_v, table, positions, *, scale=None,
                    softcap: float = 0.0, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """Same contract as ``paged_attention_stream``."""
    if on_cpu(q):
        return paged_attention_stream(q, pool_k, pool_v, table, positions,
                                      scale=scale, softcap=softcap,
                                      k_scale=k_scale, v_scale=v_scale)
    quant = k_scale is not None or v_scale is not None
    dts = tuple(DTYPE_CODES)
    i32, f32 = (torch.int32,), (torch.float32,)
    tensors = {"q": q, "pool_k": pool_k, "pool_v": pool_v, "table": table,
               "positions": positions}
    dtypes = {"q": dts, "pool_k": dts, "pool_v": dts, "table": i32,
              "positions": i32}
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("paged_attention: an int8 pool needs both "
                             "k_scale and v_scale")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
        dtypes.update(pool_k=(torch.int8,), pool_v=(torch.int8,),
                      k_scale=f32, v_scale=f32)
    device = check_cuda("paged_attention", tensors, dtypes)
    P, page, Hkv, D = pool_k.shape
    B, Hq, Dq = q.shape
    if (pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype
            or Dq != D or Hq % Hkv or table.shape[0] != B
            or positions.shape != (B,)
            or quant and (k_scale.shape != (P, Hkv)
                          or v_scale.shape != (P, Hkv))):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)}, table {tuple(table.shape)}, "
                         f"positions {tuple(positions.shape)} do not fit")
    maxp = table.shape[1]
    pl = plan(B, Hq, Hkv, D, page, maxp, pool_k.dtype)   # raises: D > 256
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    part = None                       # the splits' (m, l) and acc
    if pl.splits > 1:
        part = torch.empty(pl.splits * B * Hq * (D + 2), device=device,
                           dtype=torch.float32)
    part_ptr = ctypes.c_void_p(None if part is None else address(part))
    dims = (B, Hq, Hkv, D, page, maxp, P, float(scale), float(softcap),
            DTYPE_CODES[q.dtype])
    split = (pl.pages_per_split, pl.splits, pl.warps)
    if quant:
        KERNEL.launch("paged_attention_i8", device, ptr(q), ptr(pool_k),
                      ptr(pool_v), ptr(k_scale), ptr(v_scale), ptr(table),
                      ptr(positions), ptr(out), part_ptr, *dims, *split)
    else:
        KERNEL.launch("paged_attention", device, ptr(q), ptr(pool_k),
                      ptr(pool_v), ptr(table), ptr(positions), ptr(out),
                      part_ptr, *dims, DTYPE_CODES[pool_k.dtype], *split)
    return out
