"""Flash-attention forward (prefill): causal, sliding window, softcap, GQA,
``kv_offset``.

Port of ``repro/kernels/flash_attention.py`` and of its reference
``repro/kernels/ref.py:attention_ref``.  ``flash_attention`` is the wrapper:
on CUDA tensors it launches ``csrc/flash_attention.cu`` (or raises), on CPU
tensors it runs ``attention_ref``.  Layout (B, H, S, D), as in ``repro``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import Kernel, check_cuda, ptr

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("flash_attention", {
    "flash_attention": [_VP] * 4 + [_I] * 6 + [_F, _I, _I, _F, _I, _I]})

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    KERNEL.launch("flash_attention", device, ptr(q), ptr(k), ptr(v), ptr(o),
                  B, Hq, Hkv, Sq, Skv, D, float(scale), int(bool(causal)),
                  int(window), float(softcap), int(kv_offset),
                  DTYPE_CODES[q.dtype])
    return o
