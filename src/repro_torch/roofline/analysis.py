"""Roofline accounting for the port (port of ``repro/roofline/analysis.py``
:39-275): the hardware specs every "fraction of roofline" divides by, and
the model's useful-work counts.

* ``HardwareSpec`` and the presets: ``repro``'s (``tpu-v5e``, ``tpu-v4``,
  ``host-cpu``, ``gpu-generic``) plus ``h100``, NVIDIA's data-sheet rates
  of one H100 SXM (80 GB HBM3, 700 W): 989e12 dense bf16 FLOP/s on the
  tensor cores and 3.35e12 HBM bytes/s.  ``detect_hardware`` picks
  ``h100`` for an H100, ``gpu-generic`` for any other CUDA card and
  ``host-cpu`` for the CPU.
* ``bound`` and ``rfft_flops``: the least time for a kernel's work on the
  H100 (the larger of its bytes over the memory rate and its operations
  over the peak rate of the operands' type) and the operations of a real
  FFT; ``chip_smoke.py`` and the profiler (``obs/prof.py``) count with
  these.
* ``model_flops_per_token``, ``count_params``, ``seq_mixer_flops_per_token``
  and ``slstm_scan_correction``: ``repro``'s compression-aware counts (a
  block-circulant projection costs its FFT pipeline's FLOPs, MoE experts
  count ``top_k`` per token, attention scores and AV in the sequence-mixer
  term).  ``repro`` walks a parameter pytree whose segments stack their
  layers on a leading axis; here the walk is over the ``nn.Module``'s
  named parameters, one module a layer, and the sums are the same.

Left out: ``xla_cost_analysis``, ``CompiledCompat``, ``collective_bytes``
and ``cell_report``.  They read XLA's compiled artifacts (cost analysis,
optimized HLO, memory analysis) and belong to the dry run (ROADMAP A.16),
which is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

import torch
from torch import nn

from ..configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak rates of one device: the denominators of every roofline
    question.  ``ridge_flops_per_byte`` is the arithmetic intensity at
    which work stops being memory-bound on this part."""
    name: str
    peak_flops: float            # FLOP/s per chip
    hbm_bw: float                # HBM bytes/s per chip
    link_bw: float = 0.0         # bytes/s per interconnect link

    @property
    def ridge_flops_per_byte(self) -> float:
        return self.peak_flops / self.hbm_bw


TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9)
TPU_V4 = HardwareSpec("tpu-v4", peak_flops=275e12, hbm_bw=1.2e12,
                      link_bw=50e9)
# one server-CPU socket, order of magnitude (``repro``'s round numbers: a
# sanity scale on the host, not a calibrated claim)
HOST_CPU = HardwareSpec("host-cpu", peak_flops=2e11, hbm_bw=5e10)
GPU_GENERIC = HardwareSpec("gpu-generic", peak_flops=1e14, hbm_bw=2e12,
                           link_bw=25e9)
# H100 SXM, NVIDIA data sheet: dense bf16 on the tensor cores, HBM3 rate,
# one NVLink 4 direction (18 links x 25 GB/s)
H100 = HardwareSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9)

HARDWARE_PRESETS = {s.name: s for s in (TPU_V5E, TPU_V4, HOST_CPU,
                                        GPU_GENERIC, H100)}

# the H100's peak rate by operand type: float32 on the CUDA cores, bf16 on
# the tensor cores (dense)
H100_PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def detect_hardware(device=None) -> HardwareSpec:
    """The preset of ``device`` (default: the CUDA card where there is
    one, else the CPU): ``h100`` for an H100, ``gpu-generic`` for any other
    CUDA card, ``host-cpu`` for the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return HOST_CPU
    if "H100" in torch.cuda.get_device_name(device):
        return H100
    return GPU_GENERIC


def bound(nbytes: float, flops: float, dtype: torch.dtype,
          hbm_bw: float = H100.hbm_bw) -> Tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``flops``
    operations on ``dtype`` operands on the H100, and what bounds it:
    ``"bytes"`` (over the memory rate) or ``"operations"`` (over the peak
    rate of the type)."""
    t_bytes = nbytes / hbm_bw
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rfft_flops(rows: int, k: int) -> float:
    """Operations of ``rows`` real FFTs of length ``k`` (or their inverses):
    2.5 k log2 k each, half a complex FFT's 5 k log2 k.  The least a
    transform needs; the kernels multiply by dense DFT panels instead."""
    return 2.5 * rows * k * math.log2(k)


def _num_blocks(dim: int, k: int) -> int:
    return -(-dim // k)


def bc_flops(batch: int, n_in: int, n_out: int, k: int,
             gauss: bool = True) -> int:
    """FLOPs of the decoupled spectral pipeline (``repro``'s
    ``core/circulant.py:bc_flops``): rfft of the input, the complex MAC
    (3 real products with the Gauss trick), irfft of the output."""
    p, q, kf = _num_blocks(n_out, k), _num_blocks(n_in, k), k // 2 + 1
    fft = int(2.5 * batch * (q + p) * k * max(math.log2(k), 1))
    muls = 3 if gauss else 4
    mac = 2 * muls * batch * p * q * kf
    return fft + mac


# ---------------------------------------------------------------------------
# MODEL_FLOPS: compression-aware useful-work accounting
# ---------------------------------------------------------------------------
_DENSE_LEAVES = ("w", "up", "gate", "down", "router", "wh", "ifg")


def model_flops_per_token(params: nn.Module, cfg: ArchConfig) -> float:
    """Projection FLOPs per processed token (forward only; attention
    scores / AV and the embedding gather excluded, the tied LM head
    counted): ``repro``'s rules leaf by leaf over ``params``'s named
    parameters, without the layer axis ``repro``'s segments stack."""
    topk = max(cfg.moe.top_k, 1)
    total = 0.0
    for path, leaf in params.named_parameters():
        names = path.split(".")
        leaf_name = names[-1]
        is_expert = "experts" in names
        shape = tuple(leaf.shape)
        if leaf_name == "table":                      # tied LM head matmul
            total += 2.0 * shape[0] * shape[1]
            continue
        # an expert stack of circulant generators is (E, p, q, k)
        if leaf_name == "wc" or (is_expert and len(shape) >= 4 and
                                 leaf_name in ("up", "gate", "down")
                                 and shape[-1] <= 512):
            p_, q_, k_ = shape[-3], shape[-2], shape[-1]
            stack = math.prod(shape[:-3])
            if is_expert:                             # (E, p, q, k)
                stack = math.prod(shape[:-4]) * topk
            total += float(stack) * bc_flops(1, q_ * k_, p_ * k_, k_)
            continue
        if len(shape) >= 2 and leaf_name in _DENSE_LEAVES:
            n_in, n_out = shape[-2], shape[-1]
            stack = math.prod(shape[:-2])
            if is_expert:                             # (E, in, out)
                stack = math.prod(shape[:-3]) * topk
            total += float(stack) * 2.0 * n_in * n_out
    return total


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def seq_mixer_flops_per_token(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Algorithmic FLOPs a token of the sequence mixers (attention scores +
    AV, recurrent state updates), ``repro``'s PaLM-style convention
    extended to the recurrent kinds.  ``shape.seq_len`` is the context: a
    decode token attends to ``seq_len`` positions, a prefill token to half
    of them on average (causal)."""
    from ..models.transformer import segments_for
    S = shape.seq_len
    a = cfg.attention
    hd = a.num_heads * a.head_dim

    def ctx(kind: str) -> float:
        w = a.sliding_window
        avg = S if shape.is_decode else S / 2          # causal average
        if kind in ("attn_local", "moe_swa") and w:
            return min(w, avg)
        return avg

    total = 0.0
    if cfg.is_encoder_decoder:
        total += cfg.num_layers * 4.0 * hd * (S if shape.is_decode else S / 2)
        total += cfg.num_layers * 4.0 * hd * cfg.encoder_seq
        enc_tokens_ratio = (cfg.encoder_seq / max(S, 1)
                            if not shape.is_decode else cfg.encoder_seq)
        total += (cfg.encoder_layers * 4.0 * hd * cfg.encoder_seq *
                  (enc_tokens_ratio if shape.is_decode else
                   cfg.encoder_seq / max(S, 1)))
        return total
    for pattern, n in segments_for(cfg):
        for kind in pattern:
            if kind in ("attn", "attn_local", "moe", "moe_swa"):
                total += n * 4.0 * hd * ctx(kind)
            elif kind == "rec":
                total += n * 20.0 * (cfg.recurrent.lru_width or cfg.d_model)
            elif kind == "mlstm":
                d_in = int(cfg.d_model * cfg.recurrent.proj_factor)
                c = min(cfg.mlstm_chunk if not cfg.unroll_scan else 256, S)
                total += n * (2.0 * d_in * c + 8.0 * d_in *
                              (d_in // max(cfg.recurrent.mlstm_heads, 1)))
            elif kind == "slstm":
                total += n * (8.0 * cfg.d_model ** 2 + 64.0 * cfg.d_model)
    return total


def slstm_scan_correction(cfg: ArchConfig, shape: ShapeSpec,
                          dp_size: int) -> float:
    """FLOPs of the sLSTM time recurrence beyond one costed scan body
    (``repro``'s correction for XLA's once-counted while body): (S - 1)
    bodies of h @ W_h (2 b d 4d) and ~16 4d b gate operations a layer."""
    pattern = cfg.recurrent.pattern or ()
    if "slstm" not in pattern or shape.is_decode:
        return 0.0
    groups = cfg.num_layers // max(len(pattern), 1)
    n_slstm = sum(k == "slstm" for k in pattern) * groups
    b_local = max(shape.global_batch // dp_size, 1)
    d = cfg.d_model
    body = 2.0 * b_local * d * 4 * d + 16.0 * b_local * 4 * d
    factor = 3.0 if shape.kind == "train" else 1.0
    return n_slstm * (shape.seq_len - 1) * body * factor


def decode_shape(context: int, batch: int = 1) -> ShapeSpec:
    """A decode cell of ``batch`` tokens over ``context`` positions."""
    return ShapeSpec("decode", int(context), int(batch), "decode")


def prefill_shape(seq: int, batch: int = 1) -> ShapeSpec:
    """A prefill cell of ``batch`` sequences of ``seq`` tokens."""
    return ShapeSpec("prefill", int(seq), int(batch), "prefill")


# ---------------------------------------------------------------------------
# Least bytes of a serving dispatch (the profiler's memory term)
# ---------------------------------------------------------------------------
def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def serving_weight_bytes(params: nn.Module, cfg: ArchConfig,
                         tokens: Optional[int] = None) -> float:
    """Bytes one forward pass of ``tokens`` rows must read of the weights
    as served: every baked plane (float32, int8 or packed int4, scales
    included) and every parameter no plane replaces (norms, dense
    projections, the tied embedding table the LM head reads whole).  A
    generator whose planes are baked (a projection's ``wc``, an expert
    stack, the projections a fused cache shadows) is not read.  An expert
    stack's planes count the share of experts ``tokens`` rows can reach
    (``tokens * top_k / E``, at most all of them)."""
    from ..core.circulant import FusedProjections
    from ..layers.ffn import Experts
    from ..quant.codec import baked_caches
    topk = max(cfg.moe.top_k, 1)
    total, replaced = 0.0, set()
    for _, m, prefix, cache in baked_caches(params):
        nbytes = sum(_nbytes(t) for t in cache.values())
        if isinstance(m, Experts) and tokens is not None:
            E = cache["wr"].shape[0]
            nbytes *= min(1.0, tokens * topk / E)
        total += nbytes
        gen = getattr(m, prefix[:-len("_cache")], None)
        if isinstance(gen, torch.Tensor):
            replaced.add(id(gen))
        if isinstance(m, FusedProjections) and prefix == m.FUSED_CACHE:
            replaced.update(id(lin.wc) for lin in m.fused_linears())
    return total + sum(_nbytes(p) for p in params.parameters()
                       if id(p) not in replaced)


class ServingCounts:
    """The least work of a serving model's dispatches, for the profiler:
    ``prefill(lengths)`` and ``decode(contexts, passes, rows)`` give
    ``(flops, bytes)``.

    FLOPs are tokens x ``model_flops_per_token`` plus each token's
    ``seq_mixer_flops_per_token`` at its context.  Bytes are the weights
    as served (``serving_weight_bytes``) once a forward pass, plus the KV
    the attention layers write (prefill: each prompt position) or read
    (decode: each token's context), ``kv_bytes`` a layer and position in
    the cache's dtype; a windowed layer reads its window's."""

    def __init__(self, params: nn.Module, cfg: ArchConfig,
                 kv_bytes: float):
        from ..models.transformer import ATTN_KINDS, layer_kinds, window_for
        self.cfg = cfg
        self.params = params
        self.kv_bytes = float(kv_bytes)
        self.proj = model_flops_per_token(params, cfg)
        self._windows: Dict[int, int] = {}
        for kind in layer_kinds(cfg) if not cfg.is_encoder_decoder else ():
            if kind in ATTN_KINDS:
                w = window_for(kind, cfg)
                self._windows[w] = self._windows.get(w, 0) + 1
        if cfg.is_encoder_decoder:
            self._windows = {0: cfg.num_layers}
        self._weights: Dict[int, float] = {}
        self._mixer: Dict[Tuple[str, int], float] = {}

    def weight_bytes(self, rows: int) -> float:
        """``serving_weight_bytes`` of a pass over ``rows`` rows (only an
        MoE's expert share depends on them)."""
        rows = int(rows) if self.cfg.moe.num_experts else 0
        if rows not in self._weights:
            self._weights[rows] = serving_weight_bytes(
                self.params, self.cfg, rows if rows else None)
        return self._weights[rows]

    def _mix(self, kind: str, ctx: int) -> float:
        key = (kind, int(ctx))
        if key not in self._mixer:
            shape = (decode_shape(ctx) if kind == "decode"
                     else prefill_shape(ctx))
            self._mixer[key] = seq_mixer_flops_per_token(self.cfg, shape)
        return self._mixer[key]

    def _kv(self, contexts: np.ndarray) -> float:
        return self.kv_bytes * float(sum(
            n * (np.minimum(contexts, w) if w else contexts).sum()
            for w, n in self._windows.items()))

    def prefill(self, lengths: Iterable[int]) -> Tuple[float, float]:
        """One prefill pass over prompts of ``lengths`` true tokens."""
        lengths = np.asarray(list(lengths), np.int64)
        flops = sum(int(s) * (self.proj + self._mix("prefill", s))
                    for s in lengths)
        return (flops, self.weight_bytes(lengths.sum())
                + self._kv(lengths))

    def decode(self, contexts: Iterable[int], passes: int,
               rows: int) -> Tuple[float, float]:
        """``passes`` forward passes of ``rows`` rows that decoded one
        token for each entry of ``contexts`` (the positions it attends
        to)."""
        ctx = np.asarray(list(contexts), np.int64)
        flops = sum(self.proj + self._mix("decode", c) for c in ctx)
        return (flops, passes * self.weight_bytes(rows) + self._kv(ctx))
