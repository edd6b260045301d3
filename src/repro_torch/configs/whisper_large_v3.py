"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32 enc + 32 dec layers, d_model=1280, 20 heads (MHA, kv=20), d_ff=5120,
vocab=51866.  The conv/mel frontend is a STUB per the assignment:
``input_specs`` feeds precomputed 1500-frame embeddings to the encoder.
Decoder uses a learned position table sized for the assigned decode_32k
shape (real whisper caps at 448 — backbone-equivalent compute, noted in
DESIGN.md).  Vocab zero-pads 51866 -> 51968 = 406*128 (paper's padding rule).
"""
from .base import ArchConfig, AttentionConfig, CompressionConfig


def get_config(compress: bool = True) -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,                 # decoder
        encoder_layers=32,
        d_model=1280,
        d_ff=5120,
        vocab_size=51866,
        is_encoder_decoder=True,
        encoder_seq=1500,
        frontend="audio_stub",
        max_position=32768,
        norm="layernorm",
        ffn_activation="gelu",
        attention=AttentionConfig(num_heads=20, num_kv_heads=20, head_dim=64,
                                  learned_pos=True),
        compression=CompressionConfig(enabled=compress, block_ffn=128,
                                      block_attn=128),
    )
