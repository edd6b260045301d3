"""phi-3-vision-4.2b — VLM backbone [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini transformer backbone: 32 layers, d_model=3072, 32 heads (MHA,
kv=32, head_dim=96), d_ff=8192 (swiglu), vocab=32064 (padded 32064->32128).
The CLIP image frontend is a STUB per the assignment: ``input_specs`` feeds
576 precomputed patch embeddings that replace the first 576 token slots.
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision_stub",
        num_patches=576,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
