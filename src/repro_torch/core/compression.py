"""Compression accounting (port of ``repro/core/compression.py``): the
parameter counts and FLOPs of a layer inventory under a
``CompressionConfig``, as in the paper's storage-reduction table and its
O(n²) -> O(n log n) complexity claim.  Pure host arithmetic."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from . import circulant as cc


@dataclass
class LayerCost:
    name: str
    layer_class: str          # ffn | attn | embed | expert | other
    n_in: int
    n_out: int
    count: int = 1            # how many identical instances (layers, experts)

    def dense_params(self) -> int:
        return self.n_in * self.n_out * self.count

    def bc_params(self, k: int) -> int:
        if k <= 0:
            return self.dense_params()
        p, q = cc.num_blocks(self.n_out, k), cc.num_blocks(self.n_in, k)
        return p * q * k * self.count

    def dense_flops(self, batch: int) -> int:
        return cc.dense_flops(batch, self.n_in, self.n_out) * self.count

    def bc_flops(self, batch: int, k: int, gauss: bool = True) -> int:
        if k <= 0:
            return self.dense_flops(batch)
        return cc.bc_flops(batch, self.n_in, self.n_out, k, gauss) * self.count


def summarize(costs: List[LayerCost], comp, batch: int = 1,
              gauss: bool = True) -> Dict[str, float]:
    """Totals and compression / speedup ratios for a layer inventory."""
    dense_p = sum(c.dense_params() for c in costs)
    bc_p = sum(c.bc_params(comp.block_for(c.layer_class)) for c in costs)
    dense_f = sum(c.dense_flops(batch) for c in costs)
    bc_f = sum(c.bc_flops(batch, comp.block_for(c.layer_class), gauss)
               for c in costs)
    return {
        "dense_params": dense_p,
        "bc_params": bc_p,
        "param_compression": dense_p / max(bc_p, 1),
        "dense_flops": dense_f,
        "bc_flops": bc_f,
        "flop_reduction": dense_f / max(bc_f, 1),
    }
