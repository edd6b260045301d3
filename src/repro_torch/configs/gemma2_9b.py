"""gemma2-9b — dense decoder LM [arXiv:2408.00118].

42 layers, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336
(geglu), vocab=256000.  Local(4096-window)/global alternating attention,
attention-logit softcap 50, final-logit softcap 30, sandwich norms,
sqrt(d_model) embedding scaling.
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        d_ff=14336,
        vocab_size=256000,
        ffn_activation="gelu",
        logit_softcap=30.0,
        sandwich_norm=True,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                                  logit_softcap=50.0, sliding_window=4096,
                                  layout="alternating"),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
