"""Operations and bytes of the work a run asks of each kernel, from the
shapes the traffic needs, and the model's operations a token.

The counts follow the port's own (``kernels/bc_fused.py:work``,
``kernels/bc_grad_w.py:work``, ``kernels/flash_attention.py:work``,
``kernels/paged_attention.py:work``, ``roofline/analysis.py``), copied
here so that a change to the program cannot move the yardstick: each
input byte read once, each output byte written once, at the widths the
algorithm needs (live decode slots and true prompt tokens, never
padding).  The peaks are ``peaks.json``'s.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, Tuple

PEAKS_FILE = Path(__file__).resolve().parent.parent / "peaks.json"


def peaks() -> Dict[str, float]:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def least_s(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return max(flops / pk["flops_per_s"], nbytes / pk["bytes_per_s"])


def rfft_flops(rows: int, k: int) -> float:
    """``rows`` real FFTs of length ``k`` (or their inverses): 2.5 k log2 k
    each, half a complex FFT's 5 k log2 k."""
    return 2.5 * rows * k * math.log2(k)


def blocks(n: int, k: int) -> int:
    return -(-n // k)


def bc_fused(B: int, p: int, q: int, k: int) -> Tuple[float, float]:
    """(ops, bytes) of one spectral projection of B rows over p x q blocks
    of k with float32 planes on the Gauss lane: the input and output once
    in float32, three planes of p x q x kf float32 bins; the input and
    output real FFTs and the Gauss MAC (3 products and 3 sums a row, pair
    and bin, one operand sum a row, input block and bin, two output sums
    a row, output block and bin)."""
    kf = k // 2 + 1
    nbytes = 4 * (B * q * k + B * p * k) + 3 * p * q * 4 * kf
    mac = 6 * B * p * q * kf + B * q * kf + 2 * B * p * kf
    return rfft_flops(B * q, k) + mac + rfft_flops(B * p, k), nbytes


def bc_grad_w(N: int, p: int, q: int, k: int) -> Tuple[float, float]:
    """(ops, bytes) of one weight gradient over N rows: the output
    gradient, the input and the generators' gradient once in float32; the
    two input FFTs, the Gauss MAC with its operand and output sums and the
    inverse FFTs of the p x q result."""
    kf = k // 2 + 1
    nbytes = 4 * (N * p * k + N * q * k + p * q * k)
    flops = (rfft_flops(N * p, k) + rfft_flops(N * q, k)
             + 6 * N * p * q * kf + N * p * kf + 2 * N * q * kf
             + 2 * p * q * kf + rfft_flops(p * q, k))
    return flops, nbytes


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions."""
    return S * (S + 1) // 2


def flash(S: int, Hq: int, Hkv: int, D: int, itemsize: int
          ) -> Tuple[float, float]:
    """(ops, bytes) of causal attention over one prompt of S true tokens:
    4 D operations a kept pair and query head (QK^T and PV); Q and O at
    Hq heads, K and V at Hkv heads, each read or written once."""
    flops = 4.0 * D * Hq * causal_pairs(S)
    nbytes = itemsize * S * D * (2 * Hq + 2 * Hkv)
    return flops, nbytes


def paged(keys: Iterable[int], Hq: int, Hkv: int, D: int, q_itemsize: int,
          kv_itemsize: int) -> Tuple[float, float]:
    """(ops, bytes) of one decode step's attention in one layer over the
    live slots, slot b attending to ``keys[b]`` positions: 4 D operations
    a query head and key; each live key's K and V at the pool's width,
    each live slot's query read and output written."""
    keys = list(keys)
    live = sum(keys)
    flops = 4.0 * Hq * D * live
    nbytes = (2 * live * Hkv * D * kv_itemsize
              + 2 * len(keys) * Hq * D * q_itemsize)
    return flops, nbytes


def projections(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    """Every block-circulant projection of one layer: name -> (n_in,
    n_out), from a configuration file's sizes."""
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = head_dim(cfg)
    ff = cfg["intermediate_size"]
    return {"q": (d, H * D), "k": (d, Hkv * D), "v": (d, Hkv * D),
            "o": (H * D, d), "up": (d, ff), "gate": (d, ff), "down": (ff, d)}


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def block_of(cfg: Dict, name: str) -> int:
    bc = cfg["block_circulant"]
    return bc["block_attn"] if name in ("q", "k", "v", "o") else bc[
        "block_ffn"]


def layer_shapes(cfg: Dict):
    """(p, q, k) of every projection of one layer."""
    out = []
    for name, (n_in, n_out) in projections(cfg).items():
        k = block_of(cfg, name)
        out.append((blocks(n_out, k), blocks(n_in, k), k))
    return out


def bc_flops_algorithm(n_in: int, n_out: int, k: int) -> float:
    """The paper's operations of one row through a block-circulant
    projection: the input and output FFTs at 2.5 k log2 k, plus the
    complex MAC as 3 real products and sums a pair and bin (Gauss)."""
    p, q, kf = blocks(n_out, k), blocks(n_in, k), k // 2 + 1
    return (2.5 * (q + p) * k * max(math.log2(k), 1)
            + 2 * 3 * p * q * kf)


def projection_flops_per_token(cfg: Dict) -> float:
    """Circulant projections of every layer, one token, forward."""
    per_layer = sum(bc_flops_algorithm(n_in, n_out, block_of(cfg, name))
                    for name, (n_in, n_out) in projections(cfg).items())
    return cfg["num_hidden_layers"] * per_layer


def head_flops(cfg: Dict) -> float:
    """The tied head's operations for one token's logits."""
    return 2.0 * cfg["hidden_size"] * padded_vocab(cfg)


def attention_flops(cfg: Dict, keys: int) -> float:
    """One query token attending to ``keys`` positions, every layer."""
    return (cfg["num_hidden_layers"] * 4.0 * cfg["num_attention_heads"]
            * head_dim(cfg) * keys)


def padded_vocab(cfg: Dict) -> int:
    v = cfg["vocab_size"]
    m = cfg.get("vocab_multiple", 1)
    return -(-v // m) * m
