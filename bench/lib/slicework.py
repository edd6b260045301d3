"""The work a traced serving slice asked of each kernel, and its model
operations, from the steps the slice recorded (``lib/serve.py``): each
step's prefills (true prompt lengths) and its decode groups ``(keys0,
n)``, one live slot that decoded ``n`` tokens, attending to ``keys0``,
``keys0 + 1``, ... keys.

Readers of per-layer metrics call these with the configuration file's
sizes; the counts are ``lib/work.py``'s.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from . import work


def serve_slice(rec: Dict) -> Optional[Dict]:
    """The traced slice of a serving run, or None (untraced, training, or
    a slice in which nothing ran on a device)."""
    sl = rec.get("slice")
    if rec.get("kind") != "serve" or not sl or not sl.get("busy_s"):
        return None
    return sl


def decode_steps(steps: List[Dict]) -> Iterable[List[int]]:
    """Every decode step of the slice as the key counts of its live
    slots."""
    for st in steps:
        groups = st["decode"]
        if not groups:
            continue
        for s in range(max(n for _, n in groups)):
            yield [k0 + s for k0, n in groups if n > s]


def prefills(steps: List[Dict]) -> Iterable[int]:
    for st in steps:
        yield from st["prefills"]


def device_s(sl: Dict, names) -> float:
    return sum(sl["kernels"].get(n, 0.0) for n in names)


def bc_fused_least_s(cfg: Dict, steps: List[Dict], pk: Dict) -> float:
    """Every circulant projection of every layer on the rows the traffic
    needs: a prefill's true prompt tokens, a decode step's live slots."""
    shapes = work.layer_shapes(cfg)
    L = cfg["num_hidden_layers"]

    def rows(B: int) -> float:
        return L * sum(work.least_s(*work.bc_fused(B, p, q, k), pk)
                       for p, q, k in shapes)
    return (sum(rows(S) for S in prefills(steps))
            + sum(rows(len(keys)) for keys in decode_steps(steps)))


def paged_least_s(cfg: Dict, steps: List[Dict], pk: Dict,
                  q_itemsize: int, kv_itemsize: int) -> float:
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = work.head_dim(cfg)
    L = cfg["num_hidden_layers"]
    return sum(L * work.least_s(*work.paged(keys, H, Hkv, D, q_itemsize,
                                            kv_itemsize), pk)
               for keys in decode_steps(steps))


def flash_least_s(cfg: Dict, steps: List[Dict], pk: Dict,
                  itemsize: int) -> float:
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = work.head_dim(cfg)
    L = cfg["num_hidden_layers"]
    return sum(L * work.least_s(*work.flash(S, H, Hkv, D, itemsize), pk)
               for S in prefills(steps))


def prefill_flops(cfg: Dict, steps: List[Dict]) -> float:
    """The model's operations in the slice's prefills: every true prompt
    token through the circulant projections as the algorithm needs them
    and causal attention, and the head once (the first token)."""
    proj = work.projection_flops_per_token(cfg)
    att = work.attention_flops(cfg, 1)
    return sum(S * proj + att * S * (S + 1) / 2 + work.head_flops(cfg)
               for S in prefills(steps))


def decode_flops(cfg: Dict, steps: List[Dict]) -> float:
    """The model's operations in the slice's decode steps: every decoded
    token through the projections, attention at its own context and the
    head."""
    per_token = work.projection_flops_per_token(cfg) + work.head_flops(cfg)
    return sum(len(keys) * per_token + work.attention_flops(cfg, sum(keys))
               for keys in decode_steps(steps))


def model_flops(cfg: Dict, steps: List[Dict]) -> float:
    return prefill_flops(cfg, steps) + decode_flops(cfg, steps)


def train_slice(rec: Dict) -> Optional[Dict]:
    """The traced steps of a training run, or None (untraced, serving, or
    nothing ran on a device)."""
    sl = rec.get("slice")
    if rec.get("kind") != "train" or not sl or not sl.get("busy_s"):
        return None
    return sl
