"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The audio frontend is a stub, as in ``repro``: precomputed frame
embeddings (B, encoder_seq, d_model) enter the encoder directly.  Encoder
blocks are bidirectional self-attention and a gelu MLP (not gated);
decoder blocks are causal self-attention, cross-attention to the encoder
output, and the same MLP.  Both stacks add a learned position table
(``enc_pos``, ``dec_pos``) and use no RoPE.

The cross-attention K/V of every decoder layer are computed once a
request from the encoder output (``all_cross_kv``) and kept in the cache,
which every decoder pass then reads (``repro``'s prefill reads the fresh
K/V in the activation dtype; the cache holds the same values, and the
attention runs in float32 in both):
``{"self": {"k": (L, B, S, Hkv, D), "v": ..., "pos": (L, S)}, "cross":
(k, v)}`` with k, v (L, B, encoder_seq, Hkv, D), as ``repro``'s
``init_cache`` lays it out.  Prefill writes both in place; a decode step
writes its position of ``self`` and reads ``cross``.

``repro`` names a decoder block's self-attention ``self``; the port's
``DecoderBlock`` calls it ``self_attn`` (``models/convert.py`` maps the
name).

The training forward (``forward_train``, ``repro``'s ``forward`` in train
mode) encodes the frames, computes every decoder layer's cross (k, v)
from the encoder output (outside any checkpoint, as ``repro`` vmaps
``_cross_kv`` before its decoder scan), then decodes the tokens with
causal self-attention and cross-attention over them, with no cache.
Every encoder and decoder layer runs under ``torch.utils.checkpoint``
where ``cfg.remat == "full"``, as ``repro`` checkpoints its scans'
bodies; the cross K/V are a checkpointed layer's inputs, so their
gradient, and through it the encoder's, flows back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..dist.ctx import shard_act
from ..layers import attention as attn_lib
from ..layers import embeddings as emb_lib
from ..layers import ffn as ffn_lib
from ..layers import norms as norm_lib
from .transformer import layer_cache


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, comp = cfg.d_model, cfg.compression
        kw = dict(device=device, generator=generator)
        self.ln1 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.attn = attn_lib.Attention(cfg, d, comp, **kw)
        self.ln2 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.mlp = ffn_lib.MLP(d, cfg.d_ff, comp, gated=False, **kw)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, comp = cfg.d_model, cfg.compression
        kw = dict(device=device, generator=generator)
        self.ln1 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.self_attn = attn_lib.Attention(cfg, d, comp, **kw)
        self.ln_x = norm_lib.init_norm(cfg.norm, d, device=device)
        self.cross = attn_lib.Attention(cfg, d, comp, cross=True, **kw)
        self.ln2 = norm_lib.init_norm(cfg.norm, d, device=device)
        self.mlp = ffn_lib.MLP(d, cfg.d_ff, comp, gated=False, **kw)


class EncDec(nn.Module):
    """embed, the two position tables, the encoder and decoder stacks, the
    encoder's final norm and the decoder's; tied logits."""

    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder model")
        kw = dict(device=device, generator=generator)
        d = cfg.d_model
        self.embed = emb_lib.Embedding(cfg.padded_vocab(), d, **kw)
        self.enc_pos = emb_lib.LearnedPos(cfg.encoder_seq, d, **kw)
        self.dec_pos = emb_lib.LearnedPos(cfg.max_position or 4096, d, **kw)
        self.enc_blocks = nn.ModuleList(EncoderBlock(cfg, **kw)
                                        for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, **kw)
                                        for _ in range(cfg.num_layers))
        self.enc_norm = norm_lib.init_norm(cfg.norm, d, device=device)
        self.final_norm = norm_lib.init_norm(cfg.norm, d, device=device)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> EncDec:
    """Random serving weights from ``seed`` (``repro``'s shapes and scales,
    not its bits)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return EncDec(cfg, device=device, generator=gen)


def _layer(cfg: ArchConfig, mode: str, fn, *args):
    """``fn(*args)``, under ``checkpoint`` in train mode where
    ``cfg.remat == "full"``."""
    if mode == "train" and cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params: EncDec, frames: torch.Tensor, cfg: ArchConfig, *,
           mode: str = "serve", kernel_fn=None) -> torch.Tensor:
    """frames (B, encoder_seq, d_model) -> encoder states, same shape."""
    dtype = _dtype(cfg)
    x = frames.to(dtype) + params.enc_pos.pos.to(dtype)[None]

    def block(x, bp):
        a, _ = attn_lib.attention_block(bp.attn, bp.ln1(x), cfg=cfg,
                                        causal=False, mode=mode,
                                        kernel_fn=kernel_fn)
        x = x + a
        return x + ffn_lib.mlp(bp.mlp, bp.ln2(x), activation="gelu",
                               mode=mode, kernel_fn=kernel_fn,
                               comp=cfg.compression)

    for bp in params.enc_blocks:
        x = _layer(cfg, mode, block, shard_act(x), bp)
    return params.enc_norm(x)


def cross_kv(bp: DecoderBlock, enc_out: torch.Tensor, cfg: ArchConfig,
             mode: str = "serve", kernel_fn=None):
    """One decoder layer's cross-attention (k, v), (B, Senc, Hkv, D) each."""
    a = cfg.attention
    B, Senc, _ = enc_out.shape
    shape = (B, Senc, a.num_kv_heads, a.head_dim)
    return (bp.cross.k(enc_out, mode, kernel_fn).reshape(shape),
            bp.cross.v(enc_out, mode, kernel_fn).reshape(shape))


def all_cross_kv(params: EncDec, enc_out: torch.Tensor, cfg: ArchConfig,
                 out, mode: str = "serve", kernel_fn=None):
    """Write every decoder layer's cross (k, v) into ``out``, a pair of
    (L, B, Senc, Hkv, D) tensors (cast to their dtype); returns ``out``."""
    for i, bp in enumerate(params.dec_blocks):
        k, v = cross_kv(bp, enc_out, cfg, mode, kernel_fn)
        out[0][i].copy_(k)
        out[1][i].copy_(v)
    return out


def decode(params: EncDec, tokens: torch.Tensor, cfg: ArchConfig, *,
           cross, mode: str = "serve", cache: Optional[Dict] = None,
           cache_pos=None, kernel_fn=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  ``cross`` is the (k, v) pair of
    layer-indexed stacks (or sequences); ``cache`` the stacked
    self-attention cache, written in place at ``cache_pos``."""
    dtype = _dtype(cfg)
    B, S = tokens.shape
    x = emb_lib.embed(params.embed.table, tokens).to(dtype)
    pos0 = 0 if cache_pos is None else int(cache_pos)
    # positions past the table read its last row, as repro's gather does
    idx = torch.clamp(pos0 + torch.arange(S, device=x.device),
                      max=params.dec_pos.pos.shape[0] - 1)
    x = x + params.dec_pos.pos[idx].to(dtype)[None]

    def block(x, ck, cv, bp, c_in):
        a, _ = attn_lib.attention_block(bp.self_attn, bp.ln1(x), cfg=cfg,
                                        causal=True, cache=c_in,
                                        cache_pos=cache_pos, mode=mode,
                                        kernel_fn=kernel_fn)
        x = x + a
        a, _ = attn_lib.attention_block(bp.cross, bp.ln_x(x), cfg=cfg,
                                        causal=False, cross_kv=(ck, cv),
                                        mode=mode, kernel_fn=kernel_fn)
        x = x + a
        return x + ffn_lib.mlp(bp.mlp, bp.ln2(x), activation="gelu",
                               mode=mode, kernel_fn=kernel_fn,
                               comp=cfg.compression)

    for i, bp in enumerate(params.dec_blocks):
        x = _layer(cfg, mode, block, shard_act(x), cross[0][i], cross[1][i],
                   bp, layer_cache(cache, i))
    x = params.final_norm(x)
    return emb_lib.logits(params.embed.table, x)


def forward_train(params: EncDec, tokens: torch.Tensor,
                  frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The training forward (module docstring): tokens (B, S) and frames
    (B, encoder_seq, d_model) -> logits (B, S, V)."""
    enc = encode(params, frames, cfg, mode="train")
    kv = [cross_kv(bp, enc, cfg, "train") for bp in params.dec_blocks]
    return decode(params, tokens, cfg, cross=tuple(zip(*kv)), mode="train")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device=None,
               dtype=torch.bfloat16) -> Dict:
    """``{"self": stacked linear cache, "cross": (k, v)}``, zeros (pos -1).
    Under a float8_e4m3fn cache the cross K/V stay float32: ``repro``'s
    decode carries them as its projections return them, never cast to the
    cache's dtype."""
    device = resolve_device(device)
    cdtype = torch.float32 if dtype == torch.float8_e4m3fn else dtype
    a = cfg.attention
    L = cfg.num_layers
    shape = (L, batch, max_seq, a.num_kv_heads, a.head_dim)
    cshape = (L, batch, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device),
                     "pos": torch.full((L, max_seq), -1, dtype=torch.int32,
                                       device=device)},
            "cross": (torch.zeros(cshape, dtype=cdtype, device=device),
                      torch.zeros(cshape, dtype=cdtype, device=device))}
