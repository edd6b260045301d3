"""llama4-maverick-400b-a17b — MoE decoder LM [hf:meta-llama/Llama-4 family].

48 layers alternating dense / MoE, d_model=5120, 40 heads (GQA kv=8,
head_dim=128), expert d_ff=8192, vocab=202048 (padded -> 202112), 128 experts
top-1 routing + a shared expert (llama4-style early-fusion backbone; the
multimodal fusion frontend is out of scope for the LM shapes).  400B total /
~17B active parameters: the per-expert FFNs dominate — exactly the layer
class the paper's block-circulant compression targets (per-expert first-row
generators, (E, p, q, k)).
"""
from .base import (ArchConfig, AttentionConfig, CompressionConfig, MoEConfig)


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        d_ff=8192,
        vocab_size=202048,
        attention=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                                  rope_theta=5e5),
        moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25,
                      interleave=2, shared_expert=True,
                      router_group_size=512),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128, block_expert=128),
    )
