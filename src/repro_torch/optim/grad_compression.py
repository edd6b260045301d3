"""int8 gradient compression with error feedback (port of
``repro/optim/grad_compression.py``).

``compress_decompress(grads, ef)`` quantizes each gradient leaf to int8
with one absmax scale over the leaf (``repro``'s per-tensor scale over a
stacked leaf: over all of a ``Leaf``'s per-layer tensors here), carries the
residual in an error-feedback buffer and returns the dequantized gradients
the optimizer takes.  ``wire_allreduce_int8`` (the int8 all-reduce over a
mesh axis) needs more than one card and raises (ROADMAP A.16).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .adamw import Leaf, Tensors, q_sym


def init_error_feedback(leaves: Sequence[Leaf]) -> List[Tensors]:
    return [[torch.zeros_like(t, dtype=torch.float32) for t in leaf.tensors]
            for leaf in leaves]


def compress_decompress(grads: Sequence[Tensors], ef: Sequence[Tensors]
                        ) -> Tuple[List[Tensors], List[Tensors]]:
    """int8 round trip with error feedback.  Returns (grads', new_ef)."""
    out_g, out_e = [], []
    for gs, es in zip(grads, ef):
        g32 = [g.float() + e for g, e in zip(gs, es)]
        qs, scale = q_sym(g32)           # repro's _q: the same codec
        deq = [q.float() * scale for q in qs]
        out_g.append(deq)
        out_e.append([g - d for g, d in zip(g32, deq)])
    return out_g, out_e


def wire_allreduce_int8(grads, mesh=None, axis: str = "pod"):
    raise NotImplementedError("the int8 all-reduce over a mesh axis needs "
                              "several cards; the port runs on one "
                              "(ROADMAP A.16)")
