"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig``; every workload cell is an
``(ArchConfig, ShapeSpec)`` pair.  Configs are plain frozen dataclasses so they
hash, print, and diff cleanly, and so the launcher can build them from CLI args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Compression (the paper's technique) -- per-layer-class block sizes.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CompressionConfig:
    """Block-circulant compression policy (paper §Algorithm).

    ``block_*`` give the circulant block size k per layer class; 0/None means
    dense.  ``path`` selects the lowering: 'fft' = per-call rfft pipeline,
    'spectral' = cached-Wf frequency domain (decoupled FFT/IFFT, inference),
    'direct' = materialized circulant matmul (oracle / tiny k), 'auto'.
    """
    enabled: bool = False
    block_ffn: int = 0
    block_attn: int = 0
    block_embed: int = 0          # LM head / embedding projection
    block_expert: int = 0         # MoE expert FFNs
    path: str = "auto"
    gauss_trick: bool = True      # 3-mult complex product (beyond-paper opt)
    # fuse q/k/v and gate/up circulant projections sharing an input into one
    # FFT pipeline (beyond-paper; see EXPERIMENTS.md §Perf)
    fuse_projections: bool = False

    def block_for(self, layer_class: str) -> int:
        if not self.enabled:
            return 0
        return {
            "ffn": self.block_ffn,
            "attn": self.block_attn,
            "embed": self.block_embed,
            "expert": self.block_expert,
        }.get(layer_class, 0)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # every `interleave`-th layer is MoE (1 = every layer, 2 = alternating).
    interleave: int = 1
    shared_expert: bool = False
    router_group_size: int = 512  # tokens per routing group (bounds dispatch mem)


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10000.0
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2.5
    logit_softcap: float = 0.0     # gemma2 (50.0)
    sliding_window: int = 0        # mixtral / local layers (0 = global)
    # pattern over layers: 'global', 'local', 'alternating' (gemma2),
    # 'sliding' (mixtral — every layer windowed)
    layout: str = "global"
    learned_pos: bool = False      # whisper (no RoPE)


@dataclass(frozen=True)
class RecurrentConfig:
    kind: str = "none"             # 'rglru' | 'xlstm'
    lru_width: int = 0
    conv1d_width: int = 4
    # block pattern, e.g. ('rec','rec','attn') for recurrentgemma 1:2,
    # ('mlstm','mlstm','mlstm','slstm') for xlstm
    pattern: Tuple[str, ...] = ()
    mlstm_heads: int = 4
    proj_factor: float = 2.0       # xlstm up-projection factor


@dataclass(frozen=True)
class ArchConfig:
    name: str = "arch"
    family: str = "dense"          # dense|moe|hybrid|ssm|audio|vlm
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 1024
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    recurrent: RecurrentConfig = field(default_factory=RecurrentConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    # model-level switches
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0           # whisper: 1500 post-conv frames
    frontend: str = "none"         # 'audio_stub' | 'vision_stub'
    num_patches: int = 0           # vlm stub: patch embeddings prepended
    ffn_activation: str = "silu"   # 'silu'(swiglu) | 'gelu' | 'geglu'
    norm: str = "rmsnorm"          # 'rmsnorm' | 'layernorm'
    logit_softcap: float = 0.0     # gemma2 final-logit softcap (30.0)
    sandwich_norm: bool = False    # gemma2: post-norms on each sublayer
    tie_embeddings: bool = True
    max_position: int = 0          # learned-pos table size (0 = rope/none)
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"            # 'none'|'full'  (scan-level remat policy)
    # training
    zloss: float = 1e-4
    # lowering controls (roofline runs unroll scans: XLA cost_analysis counts
    # a while body ONCE regardless of trip count, so scanned lowerings
    # undercount FLOPs/collectives — see roofline/analysis.py)
    unroll_scan: bool = False
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 1024
    mlstm_chunk: int = 256
    # KV-cache storage dtype ('bfloat16' | 'float8_e4m3fn'): decode is
    # cache-read bound, f8 halves the dominant memory term (§Perf)
    kv_cache_dtype: str = "bfloat16"

    # -- derived ----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.attention.num_heads * self.attention.head_dim

    @property
    def kv_dim(self) -> int:
        return self.attention.num_kv_heads * self.attention.head_dim

    def padded_vocab(self, multiple: int = 128) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def with_compression(self, **kw) -> "ArchConfig":
        return dataclasses.replace(
            self, compression=dataclasses.replace(self.compression, enabled=True, **kw))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """A workload cell: sequence length x global batch, and which step it lowers."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# Archs for which long_500k is runnable (bounded-state / sub-quadratic).
LONG_CONTEXT_OK = frozenset({"recurrentgemma-2b", "xlstm-125m", "mixtral-8x7b"})


def cell_is_applicable(arch: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and arch.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention (skip per assignment; see DESIGN.md)"
    return True, ""
