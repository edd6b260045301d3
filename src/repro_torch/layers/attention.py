"""Attention block: GQA/MQA/MHA projections (with ``qwen``'s QKV bias and
per-head qk-norm), RoPE, and the cache paths both serving engines run (port
of ``repro/layers/attention.py``).

* Prefill with a dense linear cache (``cache_pos`` an int, S > 1): the
  new K/V are written into the cache at ``cache_pos`` and the block attends
  over its own projections through the flash kernel
  (``kernels/flash_attention.py``).  ``repro`` runs the same math through
  XLA (``chunked_attention``); the port wires the kernel in.
* Decode against a dense linear cache (``cache_pos`` an int, S == 1; the
  batch engine): K/V are written into the cache at ``cache_pos``, then the
  query attends over the cache's first ``cache_pos + 1`` rows through the
  flash kernel with ``causal=True, kv_offset=cache_pos``.  ``repro`` masks
  the whole cache with its ``pos`` row (-1 past ``cache_pos``); for a
  linear cache filled in order that mask keeps exactly the rows
  ``0..cache_pos``, which is what the slice and the causal offset keep.
  A read of cached K/V never narrows the query (``kv_read``): a bf16
  model attends over its float32 cache in float32, as ``repro`` does, and
  a float8_e4m3fn cache (``kv_cache_dtype``) is read by the float32
  kernels' e4m3 lane under a float32 query, as ``repro`` reads it widened
  to float32.  Writes into such a cache round as ``repro``'s ``astype``
  does (``to_cache``).
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

* Training (``mode="train"``, no cache): attention through
  ``masked_attention`` with the query positions ``0..S-1``: causal or not
  (whisper's encoder), under the block's window (mixtral, gemma2's and
  recurrentgemma's ``attn_local`` layers), over the block's own
  projections or over cross K/V computed from the encoder output (their
  gradient flows back into the encoder).  That is ``repro``'s
  ``chunked_attention`` (which ``repro`` trains through) in plain,
  differentiable PyTorch, in one chunk (no online softmax: the Sq x Skv
  scores of one layer are held at once, so results agree with ``repro``'s
  query and key chunks up to summation order); never the flash kernel,
  which has no backward.

Unlike ``repro``, whose arrays are immutable, the port writes the new K/V
into the cache and the pool IN PLACE (``index_put_`` / slice assignment):
the returned cache is the same storage that was passed in.

``kernel_fn`` (the spectral-MAC hook, ``core/circulant.py``) is passed to
the four projections.

* Sliding-window ring buffer (``window`` set and a cache of at most
  ``window`` positions, ``init_kv_cache``; mixtral, gemma2's and
  recurrentgemma's ``attn_local`` layers).  Prefill attends over
  its own projections with the window mask and keeps the last ``Smax``
  positions of k, v and ``pos`` in slots 0..Smax-1; a decode step writes
  slot ``cache_pos % Smax``.  Those two rules are ``repro``'s, and they do
  not agree on where a position lives: after a prefill of S positions,
  decode position p overwrites position ``S - Smax + (p % Smax)``, which
  is the oldest only when ``S % Smax == 0``.  So the ring can hold a
  position the window excludes (and has lost one it includes).  ``repro``
  reads the whole ring through its ``pos`` row (causal, windowed, -1 =
  empty); the port keeps the slots that mask keeps (``ring_runs``: one or
  two runs of slots) and attends over them through the flash kernel with
  ``causal=False, window=0``.  The ring's ``pos`` row lives on the host:
  every position written is a host int, so choosing the slots reads
  nothing back from the card.
* Cross-attention (``cross_kv=(k, v)``, whisper's decoder): q from ``x``,
  k and v given (B, Senc, Hkv, D), no RoPE, no cache write, non-causal;
  the query is cast to k's dtype and the output back.
* Learned positions (``learned_pos``, whisper): no RoPE; the model adds
  its position table to the embeddings.

With projection fusion (``CompressionConfig.fuse_projections``) and
block-circulant q/k/v, the three run as one call against the module's
``qkv_cache`` planes (``core/circulant.py:bc_matmul_fused``: one
fused-kernel launch); the QKV bias is added after the split and qk-norm
runs after it, as in ``repro``.  Cross-attention never fuses
(``Attention(cross=True)``), as in ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..dist.ctx import shard_heads
from ..core.circulant import (FusedProjections, Linear, LinearSpec,
                              register_planes)
from ..kernels import ops as kops
from ..quant import codec
from .embeddings import apply_rope
from .norms import RMSNorm

_NEG = -1e30


class Attention(FusedProjections, nn.Module):
    """q/k/v/o projections, qk-norm scales where the arch has them, and
    the fused q/k/v planes ``qkv_cache_*`` where projection fusion baked
    them (``serve/params.py``).  A cross-attention block (``cross=True``)
    never fuses."""
    FUSED_CACHE, FUSED = "qkv_cache", ("q", "k", "v")

    def __init__(self, cfg, d_model: int, comp=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 cross: bool = False):
        super().__init__()
        self.may_fuse = not cross
        a = cfg.attention
        # q/k/v carry the (dense) QKV bias, o never does (repro :206-207)
        spec = LinearSpec.from_config(comp, "attn", bias=a.qkv_bias)
        ospec = LinearSpec.from_config(comp, "attn")
        kw = dict(device=device, generator=generator)
        self.q = Linear(d_model, a.num_heads * a.head_dim, spec, **kw)
        self.k = Linear(d_model, a.num_kv_heads * a.head_dim, spec, **kw)
        self.v = Linear(d_model, a.num_kv_heads * a.head_dim, spec, **kw)
        self.o = Linear(a.num_heads * a.head_dim, d_model, ospec, **kw)
        if a.qk_norm:                       # per-head rmsnorm of q and k
            self.qn = RMSNorm(a.head_dim, device=device)
            self.kn = RMSNorm(a.head_dim, device=device)
        register_planes(self, self.FUSED_CACHE)


def attend(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
           q_pos0=0):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), through
    the flash kernel (which takes the (B, H, S, D) layout)."""
    o = kops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window,
        softcap=softcap, scale=scale, kv_offset=int(q_pos0))
    return o.transpose(1, 2)


def masked_attention(q, k, v, rows, kv_positions, *, causal=True, window=0,
                     softcap=0.0, scale=None):
    """Attention over a KV view with ``repro``'s mask, in plain PyTorch
    (the paged gather path's decode and train mode).

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) in any float dtype; rows:
    (B, Sq) absolute query positions; kv_positions: (B, Skv), -1 for a key
    that is not there.  Key ``c`` is visible to query row ``r`` iff
    ``kv_positions[c] >= 0``, and ``kv_positions[c] <= r`` where
    ``causal``, and ``kv_positions[c] > r - window`` where ``window``
    (``repro``'s ``_mask``); a row that sees no key comes out exactly
    zero.  The softcap applies before the mask.  Returns (B, Sq, Hq, D) in
    q.dtype.

    This is ``repro``'s ``chunked_attention`` as the gather path and the
    train mode call it.  That is XLA in ``repro``, not a Pallas kernel, so
    the port computes it with plain, differentiable PyTorch operations
    here, on the CPU and on the card alike; the kernel of the gather path
    is the gather itself."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, Sq, Hkv, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    c = kv_positions[:, None, None, None, :]
    r = rows[:, None, None, :, None]
    msk = c >= 0
    if causal:
        msk = msk & (c <= r)
    if window:
        msk = msk & (c > r - window)
    # masked_fill keeps the mask at its broadcast shape (B, 1, 1, Sq, Skv)
    # for the backward, not a full-size tensor of fill values
    s = s.masked_fill(~msk, _NEG)
    # the output does not depend on the shift: held out of the graph, its
    # gradient terms (which cancel) are not computed
    m = torch.clamp(s.amax(-1), min=_NEG).detach()
    p = torch.exp(s - m[..., None]).masked_fill(~msk, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


# |x| above this rounds past 448, the largest float8_e4m3fn: NaN in
# ml_dtypes' and XLA's casts, while torch's cast saturates it to 448
E4M3_NAN_ABOVE = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's dtype as ``repro``'s ``astype`` casts it.
    To float8_e4m3fn: round to nearest even, and NaN for a magnitude above
    464 (inf included), where torch alone would give +-448."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.float()
    return torch.where(xf.abs() > E4M3_NAN_ABOVE,
                       torch.full_like(xf, float("nan")), xf).to(dtype)


def kv_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(q, k, v) for attention over cached K/V, never narrowing the query:
    q widened to the cache's dtype (a bf16 query over a float32 cache), or
    to float32 over a float8_e4m3fn cache (the float32 kernels read e4m3
    K/V), or the cache widened to the query's (a float32 query over a bf16
    cache).  The caller casts the output back to ``q.dtype``."""
    if k.dtype == q.dtype:
        return q, k, v
    if k.dtype == torch.float8_e4m3fn:
        return q.float(), k, v
    if k.dtype.itemsize >= q.dtype.itemsize:
        return q.to(k.dtype), k, v
    return q, k.to(q.dtype), v.to(q.dtype)


def ring_runs(pos: torch.Tensor, q_pos: int, window: int
              ) -> List[Tuple[int, int]]:
    """The runs ``[a, b)`` of ring slots that ``repro``'s mask keeps for
    the query at ``q_pos``: written (``pos >= 0``), not after ``q_pos``,
    inside the window.  ``pos`` is the ring's host row."""
    p = pos.numpy()
    keep = (p >= 0) & (p <= q_pos) & (p > q_pos - window)
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], keep, [False])).astype(np.int8)))
    return list(zip(edges[0::2].tolist(), edges[1::2].tolist()))


def _ring_read(q, cache, runs, softcap):
    """One query row (B, 1, Hq, D) over the ring slots ``runs``: gathered
    into the kernel's (B, Hkv, n, D) layout in one copy (the same copy a
    whole-ring read makes), then non-causal flash over ``kv_read``'s
    operands; the output is cast back to the query's dtype."""
    kt, vt = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
    kr = torch.cat([kt[:, :, a:b] for a, b in runs], dim=2)
    vr = torch.cat([vt[:, :, a:b] for a, b in runs], dim=2)
    qr, kr, vr = kv_read(q, kr, vr)
    o = kops.flash_attention(qr.transpose(1, 2).contiguous(), kr, vr,
                             causal=False, softcap=softcap)
    return o.transpose(1, 2).to(q.dtype)


def attention_block(attn: Attention, x: torch.Tensor, *, cfg, causal=True,
                    window=0, cache: Optional[Dict] = None, cache_pos=None,
                    cross_kv=None, mode: str = "serve", block_table=None,
                    paged_impl: str = "stream", kernel_fn=None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out, cache).  ``cache`` is a dense cache
    ``{"k": (B, Smax, Hkv, D), "v": ..., "pos": (Smax,)}`` with ``cache_pos``
    the int position of the first new token (a ring buffer where ``window``
    is set and ``Smax <= window``), or, with ``block_table`` (B, maxp), a
    page pool with ``cache_pos`` a (B,) position vector.  ``cross_kv`` is
    cross-attention's given (k, v).  ``paged_impl`` picks the paged
    lowering: "stream" or "gather".  ``kernel_fn`` is the projections'
    spectral-MAC hook."""
    a = cfg.attention
    B, S, _ = x.shape
    H, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    if cross_kv is not None:
        q = attn.q(x, mode, kernel_fn)
        k, v = cross_kv
    elif (getattr(cfg.compression, "fuse_projections", False)
            and attn.q.spec.kind == "block_circulant"):
        q, k, v = attn.fused(x, mode, kernel_fn)
        if hasattr(attn.q, "b"):                         # qwen QKV bias
            q, k, v = (t + m.b.to(t.dtype)
                       for t, m in zip((q, k, v), attn.fused_linears()))
    else:
        q, k, v = (m(x, mode, kernel_fn) for m in attn.fused_linears())
    q = q.reshape(B, S, H, D)
    if cross_kv is None:
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
    if hasattr(attn, "qn"):                              # qwen3 qk-norm
        q = attn.qn(q)
        k = attn.kn(k)

    paged = block_table is not None and cache is not None and cross_kv is None
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
    if not a.learned_pos and cross_kv is None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)

    if mode == "train":
        if cache is not None:
            raise ValueError("train mode takes no cache")
        kv_positions = torch.arange(k.shape[1], device=x.device).expand(
            B, k.shape[1])
        o = masked_attention(q, k, v, positions, kv_positions,
                             causal=causal and cross_kv is None,
                             window=window, softcap=a.logit_softcap)
    elif cross_kv is not None:
        o = attend(*kv_read(q, k, v), causal=False,
                   softcap=a.logit_softcap).to(q.dtype)
    elif paged:
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
            o = shard_heads(kops.paged_attention(
                shard_heads(q[:, 0].contiguous()), pool_k, pool_v,
                block_table, cache_pos, softcap=a.logit_softcap,
                k_scale=k_sc, v_scale=v_sc))[:, None]
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
    elif cache is not None and window and cache["k"].shape[1] <= window:
        smax = cache["k"].shape[1]                       # ring buffer (SWA)
        if S == 1:
            slot = q_pos0 % smax
            cache["k"][:, slot] = to_cache(k[:, 0], cache["k"].dtype)
            cache["v"][:, slot] = to_cache(v[:, 0], cache["v"].dtype)
            cache["pos"][slot] = q_pos0
            o = _ring_read(q, cache, ring_runs(cache["pos"], q_pos0, window),
                           a.logit_softcap)
        else:
            if S < smax:
                raise ValueError(f"sliding-window prefill of {S} positions "
                                 f"cannot fill a ring of {smax}")
            cache["k"].copy_(to_cache(k[:, -smax:], cache["k"].dtype))
            cache["v"].copy_(to_cache(v[:, -smax:], cache["v"].dtype))
            cache["pos"].copy_(torch.arange(q_pos0 + S - smax, q_pos0 + S,
                                            dtype=cache["pos"].dtype))
            o = attend(q, k, v, causal=causal, window=window,
                       softcap=a.logit_softcap, q_pos0=q_pos0)
    else:
        if cache is not None:
            end = q_pos0 + S
            if end > cache["k"].shape[1]:
                raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                                 f"cannot take positions {q_pos0}..{end - 1}")
            cache["k"][:, q_pos0:end] = to_cache(k, cache["k"].dtype)
            cache["v"][:, q_pos0:end] = to_cache(v, cache["v"].dtype)
            cache["pos"][q_pos0:end] = positions[0].to(cache["pos"].dtype)
        if cache is not None and S == 1:        # decode reads the cache
            kc, vc = cache["k"][:, :end], cache["v"][:, :end]
            o = attend(*kv_read(q, kc, vc), causal=causal, window=window,
                       softcap=a.logit_softcap, q_pos0=q_pos0).to(q.dtype)
        else:
            o = attend(q, k, v, causal=causal, window=window,
                       softcap=a.logit_softcap, q_pos0=q_pos0)
    out = attn.o(o.reshape(B, S, H * D), mode, kernel_fn)
    return out, cache


def init_kv_cache(batch: int, seq: int, cfg, *, device: torch.device,
                  window: int = 0, dtype=torch.bfloat16,
                  layers: Optional[int] = None) -> Dict:
    """A linear cache of ``seq`` positions, or, with ``window``, a ring of
    ``min(window, seq)`` whose ``pos`` row is on the host (``ring_runs``
    reads it; the only place that puts it there).  ``layers`` stacks that
    many: k/v (L, B, S, Hkv, D), pos (L, S)."""
    a = cfg.attention
    size = min(window, seq) if window else seq
    lead = () if layers is None else (layers,)
    shape = (*lead, batch, size, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((*lead, size), -1, dtype=torch.int32,
                              device="cpu" if window else device)}
