"""Registry of the 10 assigned architectures (+ the paper's own benchmark
models, see benchmarks/).  ``get_config(arch_id)`` returns the full published
config; ``get_smoke_config(arch_id)`` returns a REDUCED config of the same
family for CPU smoke tests (small layers/width, few experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from . import (gemma2_9b, llama4_maverick_400b, mixtral_8x7b, phi3_vision_4_2b,
               qwen2_5_3b, qwen3_4b, recurrentgemma_2b, tinyllama_1_1b,
               whisper_large_v3, xlstm_125m)
from .base import ArchConfig

_MODULES = {
    "whisper-large-v3": whisper_large_v3,
    "gemma2-9b": gemma2_9b,
    "qwen3-4b": qwen3_4b,
    "qwen2.5-3b": qwen2_5_3b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "mixtral-8x7b": mixtral_8x7b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "xlstm-125m": xlstm_125m,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, compress: bool = True) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id].get_config(compress=compress)


def get_smoke_config(arch_id: str, compress: bool = True) -> ArchConfig:
    """Reduced same-family config: runs a forward/train step on CPU."""
    full = get_config(arch_id, compress=compress)
    a = full.attention
    heads = min(a.num_heads, 4)
    kv = max(1, min(a.num_kv_heads, heads))
    heads = (heads // kv) * kv or kv
    block = 16 if full.compression.enabled else 0
    cfg = full.replace(
        num_layers=min(full.num_layers, 2 * max(
            1, len(full.recurrent.pattern) or (2 if full.moe.num_experts and
                                               full.moe.interleave > 1 else 1))),
        d_model=128,
        d_ff=256 if full.d_ff else 0,
        vocab_size=512,
        max_position=min(full.max_position, 512) if full.max_position else 0,
        encoder_layers=min(full.encoder_layers, 2),
        encoder_seq=min(full.encoder_seq, 16) if full.encoder_seq else 0,
        num_patches=min(full.num_patches, 8) if full.num_patches else 0,
        attention=dataclasses.replace(
            a, num_heads=heads, num_kv_heads=kv, head_dim=32,
            sliding_window=min(a.sliding_window, 16) if a.sliding_window else 0),
        moe=dataclasses.replace(full.moe,
                                num_experts=min(full.moe.num_experts, 4),
                                router_group_size=32,
                                capacity_factor=8.0),  # smoke: no token drops
        recurrent=dataclasses.replace(full.recurrent,
                                      lru_width=128 if full.recurrent.lru_width else 0,
                                      mlstm_heads=min(full.recurrent.mlstm_heads, 2)),
        compression=dataclasses.replace(
            full.compression, block_ffn=block and min(full.compression.block_ffn, block),
            block_attn=block and min(full.compression.block_attn, block),
            block_expert=block and min(full.compression.block_expert, block)),
        remat="none",
    )
    return cfg
