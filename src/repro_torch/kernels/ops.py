"""The kernels' entry points for the layers, dispatched by device.

``repro/kernels/ops.py`` chooses a lowering with ``REPRO_KERNELS``; the port
chooses by the tensor it is given.  A CPU tensor takes the plain PyTorch
version, a CUDA tensor takes the hand-written kernel or raises: there is no
switch, no fallback and no ``torch.compile``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import circulant as cc
from .bc_fused import bc_fused_matmul
from .flash_attention import flash_attention
from .paged_attention import paged_attention

__all__ = ["bc_linear", "flash_attention", "paged_attention"]


def bc_linear(x: torch.Tensor, cache: Dict[str, torch.Tensor], k: int,
              n_out: int, gauss: bool = True) -> torch.Tensor:
    """Block-circulant linear against baked spectral planes:
    (..., n_in) -> (..., n_out), through the fused kernel.  Casts to
    float32 before blockifying and back to ``x.dtype`` after, as
    ``repro``'s ``bc_matmul_spectral`` does."""
    if "ws1" not in cache or not gauss:
        if x.device.type != "cpu":
            raise NotImplementedError("the fused kernel runs the Gauss "
                                      "planes (gauss_trick=True) only")
        return cc.bc_matmul_spectral(x, cache, k, n_out, gauss)
    if "wr_s" in cache:
        raise NotImplementedError("quantized spectral planes are not ported "
                                  "yet (repro.quant)")
    p, q, _ = cache["wr"].shape
    lead = x.shape[:-1]
    xb = cc._blockify(x, q, k).reshape(-1, q, k).float().contiguous()
    y = bc_fused_matmul(xb, cache["wr"], cache["ws1"], cache["ws2"], k)
    return y.reshape(*lead, p * k)[..., :n_out].to(x.dtype)
