"""qwen2.5-3b — dense decoder LM [hf:Qwen/Qwen2.5 family].

36 layers, d_model=2048, 16 heads (GQA kv=2, head_dim=128), d_ff=11008
(swiglu), vocab=151936, QKV bias enabled (biases stay dense — the circulant
structure acts on the weight matrix only).
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        d_ff=11008,
        vocab_size=151936,
        attention=AttentionConfig(num_heads=16, num_kv_heads=2, head_dim=128,
                                  qkv_bias=True, rope_theta=1e6),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
