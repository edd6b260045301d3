"""Attention block: GQA/MQA/MHA projections, RoPE, and the two cache paths
the paged serving engine runs (port of ``repro/layers/attention.py``).

* Prefill with a dense linear cache (``cache_pos`` an int, S >= 1): the
  new K/V are written into the cache at ``cache_pos`` and the block attends
  over its own projections through the flash kernel
  (``kernels/flash_attention.py``).  ``repro`` runs the same math through
  XLA (``chunked_attention``); the port wires the kernel in.
* Paged decode (``block_table`` set, S == 1): the cache is a page pool
  ``{"k": (P, page, Hkv, D), "v": ...}`` shared by every slot; position
  ``i`` of slot ``b`` lives at page ``block_table[b, i // page]``, offset
  ``i % page``.  A slot with ``cache_pos == -1`` is idle: its write goes to
  the reserved trash page 0 and its attention output is exactly zero.
  With ``paged_impl="stream"`` (the default) attention streams the pool
  through the paged flash-decode kernel (``kernels/paged_attention.py``);
  with ``"gather"`` (the parity oracle) the slot's pages are gathered into
  a contiguous view (``kernels/paged.py``) and attended with a masked
  softmax.  An int8 pool (``k_scale`` / ``v_scale`` in the cache) is
  written through ``quant/codec.py:page_scatter`` (requantize on grow).

Unlike ``repro``, whose arrays are immutable, the port writes the new K/V
into the cache and the pool IN PLACE (``index_put_`` / slice assignment):
the returned cache is the same storage that was passed in.

Not ported yet: sliding-window ring buffers, decode against a dense cache
(the batch engine), cross-attention, qk-norm and QKV bias (the qwen slice).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.circulant import Linear, LinearSpec
from ..kernels import ops as kops
from ..quant import codec
from .embeddings import apply_rope

_NEG = -1e30


class Attention(nn.Module):
    def __init__(self, cfg, d_model: int, comp=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a = cfg.attention
        if a.qk_norm or a.qkv_bias:
            raise NotImplementedError("qk-norm and QKV bias are not ported "
                                      "yet")
        if comp is not None and getattr(comp, "fuse_projections", False):
            raise NotImplementedError("fused q/k/v projections are not "
                                      "ported yet")
        spec = LinearSpec.from_config(comp, "attn")
        kw = dict(device=device, generator=generator)
        self.q = Linear(d_model, a.num_heads * a.head_dim, spec, **kw)
        self.k = Linear(d_model, a.num_kv_heads * a.head_dim, spec, **kw)
        self.v = Linear(d_model, a.num_kv_heads * a.head_dim, spec, **kw)
        self.o = Linear(a.num_heads * a.head_dim, d_model, spec, **kw)


def attend(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
           q_pos0=0):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), through
    the flash kernel (which takes the (B, H, S, D) layout)."""
    o = kops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window,
        softcap=softcap, scale=scale, kv_offset=int(q_pos0))
    return o.transpose(1, 2)


def masked_attention(q, k, v, rows, kv_positions, *, softcap=0.0,
                     scale=None):
    """Decode attention over a gathered KV view, in plain PyTorch.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) in any float dtype; rows:
    (B, Sq) absolute query positions; kv_positions: (B, Skv), -1 for a key
    that is not there.  Key ``c`` is visible to query row ``r`` iff
    ``0 <= kv_positions[c] <= r``; a row that sees no key comes out exactly
    zero.  Returns (B, Sq, Hq, D) in q.dtype.

    This is ``repro``'s ``chunked_attention`` as the gather path calls it.
    That is XLA in ``repro``, not a Pallas kernel, so the port computes it
    with plain PyTorch operations here, on the CPU and on the card alike;
    the kernel of the gather path is the gather itself."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, Sq, Hkv, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    c = kv_positions[:, None, None, None, :]
    msk = (c <= rows[:, None, None, :, None]) & (c >= 0)
    s = torch.where(msk, s, torch.full_like(s, _NEG))
    m = torch.clamp(s.amax(-1), min=_NEG)
    p = torch.where(msk, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attention_block(attn: Attention, x: torch.Tensor, *, cfg, causal=True,
                    window=0, cache: Optional[Dict] = None, cache_pos=None,
                    mode: str = "serve", block_table=None,
                    paged_impl: str = "stream"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out, cache).  ``cache`` is a dense cache
    ``{"k": (B, Smax, Hkv, D), "v": ..., "pos": (Smax,)}`` with ``cache_pos``
    the int position of the first new token, or, with ``block_table``
    (B, maxp), a page pool with ``cache_pos`` a (B,) position vector.
    ``paged_impl`` picks the paged lowering: "stream" or "gather"."""
    a = cfg.attention
    B, S, _ = x.shape
    H, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    q = attn.q(x, mode).reshape(B, S, H, D)
    k = attn.k(x, mode).reshape(B, S, Hkv, D)
    v = attn.v(x, mode).reshape(B, S, Hkv, D)

    paged = block_table is not None and cache is not None
    if paged:
        if S != 1:
            raise ValueError("the paged KV path is decode-only (S == 1)")
        if window:
            raise NotImplementedError("the paged KV path serves linear "
                                      "caches only")
        q_pos0 = torch.clamp(cache_pos, min=0)           # -1 marks idle slots
        positions = q_pos0[:, None] + torch.arange(S, device=x.device)
    else:
        q_pos0 = 0 if cache_pos is None else int(cache_pos)
        positions = (q_pos0 + torch.arange(S, device=x.device)).expand(B, S)
    if a.learned_pos:
        raise NotImplementedError("learned positions are not ported yet")
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)

    if paged:
        if paged_impl not in ("stream", "gather"):
            raise ValueError(f"paged_impl {paged_impl!r}: expected 'stream' "
                             f"or 'gather'")
        pool_k, pool_v = cache["k"], cache["v"]
        k_sc, v_sc = cache.get("k_scale"), cache.get("v_scale")
        page = pool_k.shape[1]
        maxp = block_table.shape[1]
        pos = q_pos0.long()
        col = torch.clamp(pos // page, max=maxp - 1)
        rows = torch.arange(B, device=x.device)
        pid = torch.where(cache_pos >= 0, block_table[rows, col].long(),
                          torch.zeros_like(col))       # 0 = trash page
        off = pos % page
        # duplicate writes to the trash page are unordered; nothing reads it
        if k_sc is not None:                  # int8 pool: requantize on grow
            codec.page_scatter(pool_k, k_sc, pid, off, k[:, 0])
            codec.page_scatter(pool_v, v_sc, pid, off, v[:, 0])
        else:
            pool_k.index_put_((pid, off), k[:, 0].to(pool_k.dtype))
            pool_v.index_put_((pid, off), v[:, 0].to(pool_v.dtype))
        if paged_impl == "stream":
            o = kops.paged_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                     block_table, cache_pos,
                                     softcap=a.logit_softcap, k_scale=k_sc,
                                     v_scale=v_sc)[:, None]
        else:
            kg = kops.paged_gather(pool_k, block_table)
            vg = kops.paged_gather(pool_v, block_table)
            if k_sc is not None:              # page scales, one per offset
                tl = block_table.long()
                rep = lambda sc: sc[tl].repeat_interleave(  # noqa: E731
                    page, dim=1)[..., None]
                kg = kg.float() * rep(k_sc)
                vg = vg.float() * rep(v_sc)
            idx = torch.arange(kg.shape[1], device=x.device)[None, :]
            kv_positions = torch.where(idx <= cache_pos[:, None], idx,
                                       torch.full_like(idx, -1))
            o = masked_attention(q, kg, vg, positions, kv_positions,
                                 softcap=a.logit_softcap)
    else:
        if cache is not None:
            if window and cache["k"].shape[1] <= window:
                raise NotImplementedError("sliding-window ring buffers are "
                                          "not ported yet")
            if S == 1:
                raise NotImplementedError("decode against a dense cache (the "
                                          "batch engine) is not ported yet")
            end = q_pos0 + S
            cache["k"][:, q_pos0:end] = k.to(cache["k"].dtype)
            cache["v"][:, q_pos0:end] = v.to(cache["v"].dtype)
            cache["pos"][q_pos0:end] = positions[0].to(cache["pos"].dtype)
        o = attend(q, k, v, causal=causal, window=window,
                   softcap=a.logit_softcap, q_pos0=q_pos0)
    out = attn.o(o.reshape(B, S, H * D), mode)
    return out, cache


def init_kv_cache(batch: int, seq: int, cfg, *, device: torch.device,
                  window: int = 0, dtype=torch.bfloat16) -> Dict:
    a = cfg.attention
    size = min(window, seq) if window else seq
    shape = (batch, size, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((size,), -1, dtype=torch.int32, device=device)}
