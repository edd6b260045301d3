"""qwen3-4b — dense decoder LM [hf:Qwen/Qwen3-8B family].

36 layers, d_model=2560, 32 heads (GQA kv=8, head_dim=128), d_ff=9728
(swiglu), vocab=151936, per-head q/k RMS-norm (qk_norm), no QKV bias.
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        d_ff=9728,
        vocab_size=151936,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  qk_norm=True, rope_theta=1e6),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
