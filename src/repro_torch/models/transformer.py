"""Decoder LM for every block kind of ``repro/models/transformer.py``:
``attn``, ``attn_local`` (gemma2's windowed layers), ``moe``, ``moe_swa``,
``rec`` (recurrentgemma's RG-LRU), ``mlstm`` and ``slstm`` (its port).

``repro`` stacks each segment's block params over a scan axis; the port
keeps one ``nn.Module`` per layer in a ``ModuleList`` and loops over them.
The activation-sharding pins of ``repro/dist/ctx.py`` place nothing on one
card and are dropped.

Caches (``init_cache``).  Where every layer is an attention kind with one
window, the cache is stacked over layers: ``{"k": (L, B, S, Hkv, D), "v":
..., "pos": (L, S)}`` (a ring of ``S = min(window, max_seq)`` slots under a
window, its ``pos`` rows on the host, ``layers/attention.py``), and a
paged pool ``{"k": (L, P, page, Hkv, D), "v": ...}`` (plus ``k_scale`` /
``v_scale`` (L, P, Hkv) for an int8 pool, ``serve/kvcache.py``); layer
``i`` reads and writes the views ``cache["k"][i]`` ... in place.  Where
the kinds or the windows mix (xlstm's mlstm, mlstm, slstm; gemma2's
attn_local, attn; recurrentgemma's rec, rec, attn_local), the cache is a
list with one entry a layer: a KV dict for an attention kind (a ring under
a window, linear without), the cell's state tuple (``layers/recurrent.py``)
for a recurrent one, updated in place.  ``repro`` stacks per segment
instead; the leaves are the same.

gemma2's sandwich norms (``ln1_post`` / ``ln2_post``, where the config
sets ``sandwich_norm``) normalise the attention and MLP outputs before
each residual, as ``repro``'s do.

The ``vision_stub`` frontend is ported: ``forward(..., frontend_embeds=)``
replaces the first ``num_patches`` token slots with the given patch
embeddings, exactly as ``repro`` concatenates them (a prompt shorter than
``num_patches`` comes out ``num_patches`` long).  Encoder-decoder models
(whisper) are ``models/encdec.py``.

Training (``forward(..., mode="train")``, no cache) runs every block
kind: each repeat of the segment pattern (a group) under
``torch.utils.checkpoint`` where ``cfg.remat == "full"``, as ``repro``
checkpoints its scan's group function, so the backward runs each group's
forward again.  A group returns ``(x, aux)``, ``aux`` the sum of its MoE
blocks' load-balancing losses (``layers/ffn.py:moe``), summed over the
groups as ``repro``'s group function carries it; ``forward`` returns it
in the cache's place in train mode.  Nothing in train mode writes state in
place, so the recompute cannot apply an update twice: no cache is taken
(the recurrent cells start from zeros and return their state unused) and
``MoE.logit_gap`` is not updated.

Learned positions (``max_position``: ``repro``'s ``params["pos"]``) are
added to the embedding in every mode, a decoder-only model's too
(``_positions``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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
from ..layers import recurrent as rec_lib

ATTN_KINDS = ("attn", "attn_local", "moe", "moe_swa")


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


def window_for(kind: str, cfg: ArchConfig) -> int:
    """The sliding window of a block kind (0: global attention)."""
    if kind in ("attn_local", "moe_swa"):
        return cfg.attention.sliding_window
    return 0


class Block(nn.Module):
    """An attention kind: norm → attention (windowed for ``attn_local`` and
    ``moe_swa``) → [post-norm] → residual → norm → MLP (``attn``,
    ``attn_local``) or mixture of experts (``moe``, ``moe_swa``; in
    ``self.moe``) → [post-norm] → residual; the post-norms are gemma2's
    sandwich norms.  ``rec``: norm → RG-LRU (``self.rec``) → residual →
    norm → MLP → residual.  ``mlstm`` / ``slstm``: norm → the cell
    (``self.cell``) → residual."""

    def __init__(self, kind: str, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in (*ATTN_KINDS, "rec", "mlstm", "slstm"):
            raise ValueError(f"block kind {kind!r}")
        self.kind = kind
        d, comp = cfg.d_model, cfg.compression
        kw = dict(device=device, generator=generator)
        self.ln1 = norm_lib.init_norm(cfg.norm, d, device=device)
        r = cfg.recurrent
        if kind == "mlstm":
            self.cell = rec_lib.MLSTMCell(d, r.mlstm_heads, r.proj_factor,
                                          comp, **kw)
            return
        if kind == "slstm":
            self.cell = rec_lib.SLSTMCell(d, comp, **kw)
            return
        self.ln2 = norm_lib.init_norm(cfg.norm, d, device=device)
        if kind == "rec":
            self.rec = rec_lib.RGLRU(d, r.lru_width or d, comp,
                                     r.conv1d_width, **kw)
            self.mlp = ffn_lib.MLP(d, cfg.d_ff, comp, **kw)
            return
        self.attn = attn_lib.Attention(cfg, d, comp, **kw)
        if kind in ("moe", "moe_swa"):
            self.moe = ffn_lib.MoE(d, cfg.d_ff, cfg.moe, comp, **kw)
        else:
            self.mlp = ffn_lib.MLP(d, cfg.d_ff, comp, **kw)
        if cfg.sandwich_norm:
            self.ln1_post = norm_lib.init_norm(cfg.norm, d, device=device)
            self.ln2_post = norm_lib.init_norm(cfg.norm, d, device=device)


def _store(cache, state) -> None:
    """Copy a cell's new state into the cache's tensors."""
    for t, new in zip(cache, state):
        t.copy_(new)


def apply_block(block: Block, x, cfg: ArchConfig, *, mode: str, cache=None,
                cache_pos=None, block_table=None, paged_impl: str = "stream",
                kernel_fn=None):
    """Returns (x, cache, aux); the cache is updated in place.  ``aux`` is
    an MoE block's load-balancing loss in train mode, else None."""
    aux = None
    h = block.ln1(x)
    if block.kind in ("mlstm", "slstm"):
        if block.kind == "mlstm":
            y, state = rec_lib.mlstm_block(
                block.cell, h, heads=cfg.recurrent.mlstm_heads, mode=mode,
                state=cache, chunk=cfg.mlstm_chunk, kernel_fn=kernel_fn)
        else:
            y, state = rec_lib.slstm_block(block.cell, h, mode=mode,
                                           state=cache, kernel_fn=kernel_fn)
        if cache is not None:
            _store(cache, state)
        return x + y, cache, aux
    if block.kind == "rec":
        a, state = rec_lib.rglru_block(block.rec, h, mode=mode, state=cache,
                                       kernel_fn=kernel_fn)
        if cache is not None:
            _store(cache, state)
    else:
        a, cache = attn_lib.attention_block(
            block.attn, h, cfg=cfg, causal=True,
            window=window_for(block.kind, cfg), cache=cache,
            cache_pos=cache_pos, mode=mode, block_table=block_table,
            paged_impl=paged_impl, kernel_fn=kernel_fn)
    if hasattr(block, "ln1_post"):
        a = block.ln1_post(a)
    x = x + a
    h = block.ln2(x)
    if hasattr(block, "moe"):
        f = ffn_lib.moe(block.moe, h, d_ff=cfg.d_ff, moe_cfg=cfg.moe,
                        comp=cfg.compression, activation=cfg.ffn_activation,
                        mode=mode, kernel_fn=kernel_fn)
        if mode == "train":
            f, aux = f
    else:
        f = ffn_lib.mlp(block.mlp, h, activation=cfg.ffn_activation,
                        mode=mode, kernel_fn=kernel_fn, comp=cfg.compression)
    if hasattr(block, "ln2_post"):
        f = block.ln2_post(f)
    return x + f, cache, aux


class Transformer(nn.Module):
    """embed (+ a learned position table where ``max_position`` is set) →
    blocks → final norm → tied logits.  As in ``repro``, the logits always
    come from the embedding table: ``repro`` builds no untied head and
    ignores ``tie_embeddings`` (``src/repro/models/transformer.py:165``,
    ``:298``), so an untied config computes the same tied logits."""

    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise NotImplementedError(f"{cfg.name} is an encoder-decoder "
                                      f"model: models/encdec.py serves it")
        if cfg.frontend not in ("none", "vision_stub"):
            raise NotImplementedError(f"{cfg.name}: the audio frontend of a "
                                      f"decoder-only model is not ported")
        kw = dict(device=device, generator=generator)
        self.embed = emb_lib.Embedding(cfg.padded_vocab(), cfg.d_model, **kw)
        if cfg.max_position:               # repro's params["pos"]
            self.pos = emb_lib.LearnedPos(cfg.max_position, cfg.d_model, **kw)
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
               dtype=torch.bfloat16):
    """Layer-stacked k/v (L, B, S, Hkv, D) and pos (L, S) = -1 where every
    layer is an attention kind of one window; else a list, one entry a
    layer: a KV dict (a ring of min(window, max_seq) slots for a windowed
    layer, linear for a global one) or a cell's float32 state.  Either KV
    layout comes from ``layers/attention.py:init_kv_cache``."""
    device = resolve_device(device)
    kinds = layer_kinds(cfg)
    windows = {window_for(kind, cfg) for kind in kinds}
    if all(kind in ATTN_KINDS for kind in kinds) and len(windows) == 1:
        return attn_lib.init_kv_cache(batch, max_seq, cfg, device=device,
                                      window=windows.pop(), dtype=dtype,
                                      layers=len(kinds))
    r = cfg.recurrent
    out: List = []
    for kind in kinds:
        if kind in ATTN_KINDS:
            out.append(attn_lib.init_kv_cache(batch, max_seq, cfg,
                                              device=device,
                                              window=window_for(kind, cfg),
                                              dtype=dtype))
        elif kind == "mlstm":
            d_in = int(cfg.d_model * r.proj_factor)
            out.append(rec_lib.init_mlstm_state(
                batch, r.mlstm_heads, d_in // r.mlstm_heads, device=device))
        elif kind == "slstm":
            out.append(rec_lib.init_slstm_state(batch, cfg.d_model,
                                                device=device))
        else:                                           # rec
            out.append(rec_lib.init_rglru_state(
                batch, r.lru_width or cfg.d_model, r.conv1d_width,
                device=device))
    return out


def layer_cache(cache, i: int):
    """Layer ``i``'s entry of a per-layer cache, or its views of a
    layer-stacked cache or pool."""
    if cache is None:
        return None
    if isinstance(cache, list):
        return cache[i]
    return {key: t[i] for key, t in cache.items()}


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a cache (any nesting of dicts, lists and
    tuples)."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        cache = cache.values()
    return sum(cache_bytes(c) for c in cache)


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, *,
            mode: str = "serve", cache=None, cache_pos=None,
            block_table=None, paged_impl: str = "stream", kernel_fn=None,
            frontend_embeds: Optional[torch.Tensor] = None):
    """tokens: (B, S) int.  Returns (logits (B, S', V), cache); ``cache`` is
    updated in place.  ``paged_impl`` picks the paged attention lowering
    ("stream" or the "gather" oracle, ``layers/attention.py``);
    ``kernel_fn`` is every projection's spectral-MAC hook
    (``core/circulant.py``).  ``frontend_embeds`` (B, num_patches, d_model)
    replace the first ``num_patches`` token slots, so ``S' = max(S,
    num_patches)``.  Train mode returns (logits, aux) instead: ``aux`` the
    float32 sum of the MoE blocks' load-balancing losses (0 without
    any)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = emb_lib.embed(params.embed.table, tokens,
                      scale_by_dim=cfg.name.startswith(("gemma", "recurrent")))
    x = x.to(dtype)
    if frontend_embeds is not None:
        n = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(dtype), x[:, n:]], dim=1)
    if hasattr(params, "pos"):            # as repro's forward adds it
        x = x + _positions(params.pos.pos, cache_pos, x.shape[1]).to(dtype)
    aux = None
    if mode == "train":
        if cache is not None:
            raise ValueError("train mode takes no cache")
        x, aux = _train_blocks(params, x, cfg)
    for i, block in enumerate(params.blocks if mode != "train" else ()):
        x = shard_act(x)                  # block-boundary sharding pin
        x, _, _ = apply_block(block, x, cfg, mode=mode,
                              cache=layer_cache(cache, i),
                              cache_pos=cache_pos, block_table=block_table,
                              paged_impl=paged_impl, kernel_fn=kernel_fn)
    x = params.final_norm(shard_act(x))
    logits = emb_lib.logits(params.embed.table, x, softcap=cfg.logit_softcap)
    return logits, (aux if mode == "train" else cache)


def _positions(table: torch.Tensor, cache_pos, S: int) -> torch.Tensor:
    """Rows of a learned position table for S new positions from
    ``cache_pos`` (None: 0): (1, S, d) for an int, (B, S, d) for a (B,)
    position vector (idle slots, -1, read row 0)."""
    if cache_pos is None or not isinstance(cache_pos, torch.Tensor):
        pos0 = 0 if cache_pos is None else int(cache_pos)
        return table[pos0:pos0 + S][None]
    idx = torch.clamp(cache_pos.long(), min=0)[:, None] + torch.arange(
        S, device=table.device)
    return table[idx]


def _train_blocks(params: Transformer, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks in train mode, one group (a repeat of its segment's
    pattern) at a time, each under ``checkpoint`` where ``cfg.remat ==
    "full"``: (x, the float32 sum of the MoE blocks' aux losses)."""
    def group(x, aux, blocks):
        for block in blocks:
            x = shard_act(x)
            x, _, a = apply_block(block, x, cfg, mode="train")
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = 0
    for pattern, n in segments_for(cfg):
        for _ in range(n):
            blocks = list(params.blocks[layer:layer + len(pattern)])
            layer += len(pattern)
            if cfg.remat == "full":
                x, aux = checkpoint(group, x, aux, blocks,
                                    use_reentrant=False)
            else:
                x, aux = group(x, aux, blocks)
    return x, aux
