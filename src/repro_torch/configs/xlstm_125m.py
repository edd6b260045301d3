"""xlstm-125m — sLSTM + mLSTM block stack [arXiv:2405.04517].

12 layers, d_model=768, 4 heads, vocab=50304, d_ff=0 (the up/down
projections live inside the xLSTM cells; mLSTM uses a 2x up-projection).
Pattern (mlstm, mlstm, slstm) x 4.  Matrix/scalar memories are O(1) state =>
runs the long_500k decode cell.  Gate recurrences are elementwise; the
cells' q/k/v/up/down projections take the paper's block-circulant form.
"""
from .base import (ArchConfig, AttentionConfig, CompressionConfig,
                   RecurrentConfig)


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        d_ff=0,
        vocab_size=50304,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=192),
        recurrent=RecurrentConfig(kind="xlstm", mlstm_heads=4,
                                  proj_factor=2.0,
                                  pattern=("mlstm", "mlstm", "slstm")),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
