"""recurrentgemma-2b — Griffin hybrid (RG-LRU + local attention) [arXiv:2402.19427].

26 layers in a 1:2 pattern (rec, rec, attn_local), d_model=2560, 10 heads
(MQA kv=1, head_dim=256), d_ff=7680 (geglu), vocab=256000, 2048-token local
attention window, RG-LRU recurrence width 2560.  Bounded state => runs the
long_500k decode cell.  The diagonal RG-LRU recurrence has no weight matrix
to compress (DESIGN.md §Arch-applicability); the block's in/out projections
are block-circulant.
"""
from .base import (ArchConfig, AttentionConfig, CompressionConfig,
                   RecurrentConfig)


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        d_ff=7680,
        vocab_size=256000,
        ffn_activation="gelu",
        attention=AttentionConfig(num_heads=10, num_kv_heads=1, head_dim=256,
                                  sliding_window=2048),
        recurrent=RecurrentConfig(kind="rglru", lru_width=2560,
                                  conv1d_width=4,
                                  pattern=("rec", "rec", "attn_local")),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
