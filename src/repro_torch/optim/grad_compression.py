"""int8 gradient compression with error feedback (port of
``repro/optim/grad_compression.py``).

``compress_decompress(grads, ef)`` quantizes each gradient leaf to int8
with one absmax scale over the leaf (``repro``'s per-tensor scale over a
stacked leaf: over all of a ``Leaf``'s per-layer tensors here), carries the
residual in an error-feedback buffer and returns the dequantized gradients
the optimizer takes.  ``wire_allreduce_int8`` is the explicit int8
all-reduce over one axis of a ``DeviceMesh`` (``launch/mesh.py``): int32
sums of int8 codes and the largest scale cross the axis's process group.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def wire_allreduce_int8(grads, mesh, axis: str = "pod"):
    """``repro``'s wire-format all-reduce over the mesh axis ``axis``, each
    tensor of ``grads`` (a tensor, or dicts / lists / tuples of them) on
    its own: quantize to int8 with one absmax scale, all-reduce the codes
    as int32 (SUM) and the scale (MAX) over the axis's process group, then
    ``sum * max_scale / n`` in the gradient's dtype (n the axis's size).
    On one rank that is the int8 round trip."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def one(g: torch.Tensor) -> torch.Tensor:
        qs, scale = q_sym([g.float()])
        acc = qs[0].to(torch.int32)
        smax = scale.reshape(1).clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return (acc.float() * smax[0] / n).to(g.dtype)

    return _tree_map(one, grads)
