"""Feed-forward layers: the gated MLP (unfused up/gate).

Not ported yet: mixture-of-experts and the fused up/gate projection.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.circulant import Linear, LinearSpec


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                     # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    raise NotImplementedError(f"activation {name!r}")


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, comp=None, gated: bool = True,
                 *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if comp is not None and getattr(comp, "fuse_projections", False):
            raise NotImplementedError("fused up/gate projections are not "
                                      "ported yet")
        spec = LinearSpec.from_config(comp, "ffn")
        kw = dict(device=device, generator=generator)
        self.up = Linear(d_model, d_ff, spec, **kw)
        self.down = Linear(d_ff, d_model, spec, **kw)
        self.gate = Linear(d_model, d_ff, spec, **kw) if gated else None


def mlp(m: MLP, x: torch.Tensor, *, activation: str = "silu",
        mode: str = "serve", kernel_fn=None) -> torch.Tensor:
    """``kernel_fn`` is the spectral-MAC hook of the three projections
    (``core/circulant.py``)."""
    up = m.up(x, mode, kernel_fn)
    if m.gate is not None:
        up = _act(activation, m.gate(x, mode, kernel_fn)) * up
    else:
        up = _act(activation, up)
    return m.down(up, mode, kernel_fn)
