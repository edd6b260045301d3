"""mixtral-8x7b — MoE decoder LM [arXiv:2401.04088].

32 layers, d_model=4096, 32 heads (GQA kv=8, head_dim=128), expert
d_ff=14336 (swiglu), vocab=32000, 8 experts top-2 routing, sliding-window
attention (4096) on every layer — the SWA ring cache is what makes the
long_500k decode cell O(window) rather than O(seq).
"""
from .base import (ArchConfig, AttentionConfig, CompressionConfig, MoEConfig)


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=32000,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  sliding_window=4096, layout="sliding",
                                  rope_theta=1e6),
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                      router_group_size=512),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128, block_expert=128),
    )
