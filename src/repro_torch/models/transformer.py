"""Decoder LM for the ``attn`` block kind (port of ``repro/models/transformer.py``).

``repro`` stacks each segment's block params over a scan axis; the port
keeps one ``nn.Module`` per layer in a ``ModuleList`` and loops over them.
The activation-sharding pins of ``repro/dist/ctx.py`` place nothing on one
card and are dropped.

Caches are stacked over layers: a dense cache is
``{"k": (L, B, S, Hkv, D), "v": ..., "pos": (L, S)}`` and a paged pool
``{"k": (L, P, page, Hkv, D), "v": ...}`` (plus ``k_scale`` / ``v_scale``
(L, P, Hkv) for an int8 pool, ``serve/kvcache.py``); layer ``i`` reads and
writes the views ``cache["k"][i]`` ... in place.

Not ported yet: the other block kinds (sliding-window, MoE, recurrent,
xLSTM), learned positions and frontend embeddings.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..layers import attention as attn_lib
from ..layers import embeddings as emb_lib
from ..layers import ffn as ffn_lib
from ..layers import norms as norm_lib

PORTED_KINDS = ("attn",)


def segments_for(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """Segment plan for an arch (pattern, repeat), as in ``repro``."""
    pat = cfg.recurrent.pattern
    if pat:                                   # hybrid / ssm archs define theirs
        period = len(pat)
        n, rem = divmod(cfg.num_layers, period)
        segs = [(tuple(pat), n)] if n else []
        if rem:
            segs.append((tuple(pat[:rem]), 1))
        return segs
    if cfg.moe.num_experts:
        if cfg.moe.interleave > 1:
            pat = tuple(["attn", "moe"] * (cfg.moe.interleave // 2))
        else:
            pat = ("moe_swa",) if cfg.attention.layout == "sliding" else ("moe",)
    elif cfg.attention.layout == "alternating":
        pat = ("attn_local", "attn")
    elif cfg.attention.layout == "sliding":
        pat = ("attn_local",)
    else:
        pat = ("attn",)
    period = len(pat)
    n, rem = divmod(cfg.num_layers, period)
    segs = [(tuple(pat), n)] if n else []
    if rem:
        segs.append((tuple(pat[:rem]), 1))
    return segs


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Block kind of every layer, in order (segments unrolled)."""
    return [kind for pattern, n in segments_for(cfg)
            for _ in range(n) for kind in pattern]


class Block(nn.Module):
    """``attn`` block: rmsnorm → attention → residual → rmsnorm → MLP →
    residual."""

    def __init__(self, kind: str, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"block kind {kind!r} of {cfg.name} is "
                                      f"not ported yet")
        d, comp = cfg.d_model, cfg.compression
        kw = dict(device=device, generator=generator)
        self.ln1 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.attn = attn_lib.Attention(cfg, d, comp, **kw)
        self.ln2 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.mlp = ffn_lib.MLP(d, cfg.d_ff, comp, **kw)


def apply_block(block: Block, x, cfg: ArchConfig, *, mode: str, cache=None,
                cache_pos=None, block_table=None, paged_impl: str = "stream"):
    """Returns (x, cache)."""
    h = block.ln1(x)
    a, cache = attn_lib.attention_block(
        block.attn, h, cfg=cfg, causal=True, window=0, cache=cache,
        cache_pos=cache_pos, mode=mode, block_table=block_table,
        paged_impl=paged_impl)
    x = x + a
    h = block.ln2(x)
    x = x + ffn_lib.mlp(block.mlp, h, activation=cfg.ffn_activation,
                        mode=mode)
    return x, cache


class Transformer(nn.Module):
    """embed → blocks → final norm → tied logits."""

    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.max_position or cfg.frontend != "none" or cfg.is_encoder_decoder:
            raise NotImplementedError(f"{cfg.name}: learned positions, "
                                      f"frontends and encoder-decoder stacks "
                                      f"are not ported yet")
        if not cfg.tie_embeddings:
            raise NotImplementedError("untied LM heads are not ported yet")
        kw = dict(device=device, generator=generator)
        self.embed = emb_lib.Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(kind, cfg, **kw)
                                    for kind in layer_kinds(cfg))
        self.final_norm = norm_lib.init_norm(cfg.norm, cfg.d_model,
                                             device=device)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> Transformer:
    """Random serving weights from ``seed``: ``repro``'s shapes and scales
    drawn with a ``torch.Generator`` on ``device`` (not ``repro``'s bits)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Transformer(cfg, device=device, generator=gen)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device=None,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Dense cache stacked over layers: k/v (L, B, max_seq, Hkv, D), pos
    (L, max_seq) = -1."""
    device = resolve_device(device)
    a = cfg.attention
    L = len(layer_kinds(cfg))
    shape = (L, batch, max_seq, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((L, max_seq), -1, dtype=torch.int32,
                              device=device)}


def layer_cache(cache: Optional[Dict], i: int) -> Optional[Dict]:
    """Layer ``i``'s views of a layer-stacked cache or pool."""
    if cache is None:
        return None
    return {key: t[i] for key, t in cache.items()}


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, *,
            mode: str = "serve", cache: Optional[Dict] = None, cache_pos=None,
            block_table=None, paged_impl: str = "stream"):
    """tokens: (B, S) int.  Returns (logits (B, S, V), cache); ``cache`` is
    updated in place.  ``paged_impl`` picks the paged attention lowering
    ("stream" or the "gather" oracle, ``layers/attention.py``)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = emb_lib.embed(params.embed.table, tokens,
                      scale_by_dim=cfg.name.startswith(("gemma", "recurrent")))
    x = x.to(dtype)
    for i, block in enumerate(params.blocks):
        x, _ = apply_block(block, x, cfg, mode=mode,
                           cache=layer_cache(cache, i), cache_pos=cache_pos,
                           block_table=block_table, paged_impl=paged_impl)
    x = params.final_norm(x)
    logits = emb_lib.logits(params.embed.table, x, softcap=cfg.logit_softcap)
    return logits, cache
