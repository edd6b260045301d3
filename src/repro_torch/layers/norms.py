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


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / std * scale + bias`` over the last axis, computed in
    float32, returned in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.pow(var + eps, -0.5)
    return (y * scale + bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Scale (ones) and bias (zeros), as ``repro``'s ``init_layernorm``."""

    def __init__(self, dim: int, *, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((dim,), device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros((dim,), device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x)


def init_norm(kind: str, dim: int, *, device: torch.device) -> nn.Module:
    """``RMSNorm`` for "rmsnorm", ``LayerNorm`` otherwise (``repro``'s
    ``init_norm``)."""
    if kind == "rmsnorm":
        return RMSNorm(dim, device=device)
    return LayerNorm(dim, device=device)
