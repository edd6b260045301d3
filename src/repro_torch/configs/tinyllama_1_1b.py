"""tinyllama-1.1b — llama2-architecture small LM [arXiv:2401.02385].

22 layers, d_model=2048, 32 heads (GQA kv=4, head_dim=64), d_ff=5632
(swiglu), vocab=32000.
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        d_ff=5632,
        vocab_size=32000,
        attention=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=64),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
