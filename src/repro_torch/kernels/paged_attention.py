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
"""
from __future__ import annotations

import ctypes

import torch

from .build import Kernel, check_cuda, ptr

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("paged_attention", {
    "paged_attention": [_VP] * 6 + [_I] * 7 + [_F, _F, _I, _I],
    "paged_attention_i8": [_VP] * 8 + [_I] * 7 + [_F, _F, _I]})

_NEG = -1e30
BLOCK_PAGES = 4           # pages per step of the plain streamed loop
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16            # query heads per KV head the CUDA block serves


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
    if q.device.type == "cpu":
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
    if D > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_attention: head dim {D} (max "
                         f"{MAX_HEAD_DIM}) or group {Hq // Hkv} (max "
                         f"{MAX_GROUP}) too large")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    dims = (B, Hq, Hkv, D, page, table.shape[1], P, float(scale),
            float(softcap), DTYPE_CODES[q.dtype])
    if quant:
        KERNEL.launch("paged_attention_i8", device, ptr(q), ptr(pool_k),
                      ptr(pool_v), ptr(k_scale), ptr(v_scale), ptr(table),
                      ptr(positions), ptr(out), *dims)
    else:
        KERNEL.launch("paged_attention", device, ptr(q), ptr(pool_k),
                      ptr(pool_v), ptr(table), ptr(positions), ptr(out),
                      *dims, DTYPE_CODES[pool_k.dtype])
    return out
