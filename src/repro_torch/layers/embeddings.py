"""Token embeddings, the tied LM head, learned position tables and rotary
position embeddings.

As in ``repro``, the embedding gather and the tied logits product are
plain tensor operations outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Embedding(nn.Module):
    """Dense table (vocab, dim), drawn N(0, 1/dim) like ``repro``'s
    ``init_embedding`` (zeros without a generator)."""

    def __init__(self, vocab: int, dim: int, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = (torch.randn((vocab, dim), generator=generator, device=device)
                 * dim ** -0.5 if generator is not None
                 else torch.zeros((vocab, dim), device=device))
        self.table = nn.Parameter(table, requires_grad=False)


class LearnedPos(nn.Module):
    """A learned position table ``pos`` (max_pos, dim), drawn N(0, 0.02^2)
    like ``repro``'s ``init_learned_pos`` (zeros without a generator)."""

    def __init__(self, max_pos: int, dim: int, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pos = (torch.randn((max_pos, dim), generator=generator, device=device)
               * 0.02 if generator is not None
               else torch.zeros((max_pos, dim), device=device))
        self.pos = nn.Parameter(pos, requires_grad=False)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale_by_dim: bool = False) -> torch.Tensor:
    t = table[tokens]
    if scale_by_dim:                       # gemma-style sqrt(d) input scaling
        t = t * (table.shape[-1] ** 0.5)
    return t


def logits(table: torch.Tensor, x: torch.Tensor,
           softcap: float = 0.0) -> torch.Tensor:
    """Tied LM head: x @ table.T in x.dtype (+ optional final softcap)."""
    out = x @ table.to(x.dtype).T
    if softcap:
        out = softcap * torch.tanh(out / softcap)
    return out


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """theta ** (-2i / head_dim) in float32.  theta is filled on the device
    (no host-to-device copy), so a decode step that calls this can be
    captured in a CUDA graph."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Split-half RoPE in float32.  x: (..., S, H, D) or (..., S, D);
    positions: (..., S) integer."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)             # (D/2,)
    ang = positions[..., None].float() * freqs         # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                       # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
