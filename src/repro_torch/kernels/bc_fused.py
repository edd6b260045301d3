"""The block-circulant linear in one pass: DFT → Gauss spectral MAC → iDFT.

Port of ``repro/kernels/bc_fused.py``.  ``bc_fused_matmul`` is the wrapper:
on a CUDA tensor it launches ``csrc/bc_fused.cu`` (or raises), on a CPU
tensor it runs ``bc_fused_matmul_plain``, the ``bc_matmul_spectral`` math in
plain PyTorch.  There is no other fallback.

    xb (B, q, k)  --Cr/Ci-->  Xr/Xi (B, q, kf)
    Gauss 3-product MAC over q against wr/ws1/ws2 (p, q, kf)
    Yr/Yi (B, p, kf)  --Dr/Di-->  y (B, p, k)

All float32: the serve path casts activations to float32 before
blockifying and back after (``kernels/ops.py:bc_linear``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import circulant as cc
from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("bc_fused", {"bc_fused": [_VP] * 9 + [_I] * 6})

PTILE = 8                 # output blocks per CUDA block
MAX_ROWS = 4              # input rows per CUDA block (csrc kMaxRows)


def bc_fused_matmul_plain(xb: torch.Tensor, wr: torch.Tensor,
                          ws1: torch.Tensor, ws2: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Plain PyTorch version: ``repro``'s ``bc_matmul_spectral`` on
    blockified float32 input.  xb (B, q, k) -> (B, p, k)."""
    xr, xi = cc.rfft_planes(xb, k)
    yr, yi = cc._gauss_contract(xr, xi, {"wr": wr, "ws1": ws1, "ws2": ws2},
                                "bqf,pqf->bpf")
    return cc.irfft_planes(yr, yi, k)


def rows_per_block(B: int) -> int:
    """Input rows per CUDA block: 1 while the batch is small (decode), so the
    grid has a block per row; up to 4 at prefill, so each weight value read
    serves 4 rows."""
    return 1 if B <= 64 else MAX_ROWS


def bc_fused_matmul(xb: torch.Tensor, wr: torch.Tensor, ws1: torch.Tensor,
                    ws2: torch.Tensor, k: int) -> torch.Tensor:
    """xb: (B, q, k) float32; planes (p, q, k//2+1) float32 -> (B, p, k)."""
    if xb.device.type == "cpu":
        return bc_fused_matmul_plain(xb, wr, ws1, ws2, k)
    f32 = (torch.float32,)
    device = check_cuda("bc_fused", {"xb": xb, "wr": wr, "ws1": ws1,
                                     "ws2": ws2},
                        {n: f32 for n in ("xb", "wr", "ws1", "ws2")})
    B, q, kx = xb.shape
    p, qw, kf = wr.shape
    if kx != k or qw != q or kf != k // 2 + 1:
        raise ValueError(f"bc_fused: xb {tuple(xb.shape)} and planes "
                         f"{tuple(wr.shape)} do not fit block size {k}")
    if ws1.shape != wr.shape or ws2.shape != wr.shape:
        raise ValueError("bc_fused: wr/ws1/ws2 must share one shape")
    if k > cc._DFT_MATMUL_MAX:
        raise ValueError(f"bc_fused: block size {k} > {cc._DFT_MATMUL_MAX}")
    cr, ci, dr, di = cc.dft_mats(k, device)
    y = torch.empty((B, p, k), device=device, dtype=torch.float32)
    KERNEL.launch("bc_fused", device, ptr(xb), ptr(wr), ptr(ws1), ptr(ws2),
                  ptr(cr), ptr(ci), ptr(dr), ptr(di), ptr(y),
                  B, p, q, k, rows_per_block(B), PTILE)
    return y
