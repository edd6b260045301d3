"""Normalization layers (float32 statistics whatever the activation dtype)."""
from __future__ import annotations

import torch
from torch import nn


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)``, computed in float32, returned in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.pow(var + eps, -0.5)
    return (y * (1.0 + scale)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros((dim,), device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


def init_norm(kind: str, dim: int, *, device: torch.device) -> RMSNorm:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return RMSNorm(dim, device=device)
