"""The block-circulant linear in one pass: DFT → Gauss spectral MAC → iDFT.

Port of ``repro/kernels/bc_fused.py``.  ``bc_fused_matmul`` is the wrapper:
on a CUDA tensor it launches ``csrc/bc_fused.cu`` (or raises), on a CPU
tensor it runs ``bc_fused_matmul_plain``, the ``bc_matmul_spectral`` math in
plain PyTorch.  There is no other fallback.

    xb (B, q, k)  --Cr/Ci-->  Xr/Xi (B, q, kf)
    Gauss 3-product MAC over q against wr/ws1/ws2 (p, q, kf)
    Yr/Yi (B, p, kf)  --Dr/Di-->  y (B, p, k)

Three lanes, chosen by the planes' dtype: float32; int8 and packed int4
(``uint8``, two nibbles per byte, ``kf`` padded to even), each quantized
plane with its float32 per-block-row scales (p, 1) (``repro_torch.quant``).
A quantized lane reads the int8 / int4 values, widens them in registers and
folds each plane's scale into its sum, as ``repro``'s ``_gauss_contract``
does; the planes are never dequantized in device memory.  Activations are
float32: the serve path casts them before blockifying and back after
(``kernels/ops.py:bc_linear``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core import circulant as cc
from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("bc_fused", {"bc_fused": [_VP] * 9 + [_I] * 6,
                             "bc_fused_i8": [_VP] * 12 + [_I] * 6,
                             "bc_fused_i4": [_VP] * 12 + [_I] * 6})
# the exported function of each plane dtype (one lane each)
LANES = {torch.float32: "bc_fused", torch.int8: "bc_fused_i8",
         torch.uint8: "bc_fused_i4"}

PTILE = 8                 # output blocks per CUDA block
MAX_ROWS = 4              # input rows per CUDA block (csrc kMaxRows)


def bc_fused_matmul_plain(xb: torch.Tensor, wr: torch.Tensor,
                          ws1: torch.Tensor, ws2: torch.Tensor, k: int,
                          scales: Optional[Sequence[torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: ``repro``'s ``bc_matmul_spectral`` on
    blockified float32 input, on a float32 or a quantized cache.
    xb (B, q, k) -> (B, p, k)."""
    cache = {"wr": wr, "ws1": ws1, "ws2": ws2}
    if scales is not None:
        cache.update(zip(("wr_s", "ws1_s", "ws2_s"), scales))
    xr, xi = cc.rfft_planes(xb, k)
    yr, yi = cc._gauss_contract(xr, xi, cache, "bqf,pqf->bpf")
    return cc.irfft_planes(yr, yi, k)


def rows_per_block(B: int) -> int:
    """Input rows per CUDA block: 1 while the batch is small (decode), so the
    grid has a block per row; up to 4 at prefill, so each weight value read
    serves 4 rows."""
    return 1 if B <= 64 else MAX_ROWS


def bc_fused_matmul(xb: torch.Tensor, wr: torch.Tensor, ws1: torch.Tensor,
                    ws2: torch.Tensor, k: int,
                    scales: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """xb: (B, q, k) float32; planes (p, q, k//2+1) float32, or int8 / packed
    uint8 with ``scales`` = (s_wr, s_ws1, s_ws2), each (p, 1) float32
    -> (B, p, k) float32."""
    if xb.device.type == "cpu":
        return bc_fused_matmul_plain(xb, wr, ws1, ws2, k, scales)
    lane = LANES.get(wr.dtype)
    tensors = {"xb": xb, "wr": wr, "ws1": ws1, "ws2": ws2}
    dtypes = {"xb": (torch.float32,)}
    dtypes.update({n: (wr.dtype,) for n in ("ws1", "ws2")})
    if scales is not None:
        tensors.update(zip(("s_wr", "s_ws1", "s_ws2"), scales))
        dtypes.update({n: (torch.float32,)
                       for n in ("s_wr", "s_ws1", "s_ws2")})
    device = check_cuda("bc_fused", tensors, dtypes)
    if lane is None or (scales is None) != (wr.dtype == torch.float32):
        raise ValueError(f"bc_fused: planes of dtype {wr.dtype} "
                         f"{'with' if scales is not None else 'without'} "
                         f"scales; expected float32 planes without scales "
                         f"or int8 / uint8 planes with them")
    B, q, kx = xb.shape
    p, qw, kw = wr.shape
    kf = k // 2 + 1
    want_kw = (kf + 1) // 2 if wr.dtype == torch.uint8 else kf
    if kx != k or qw != q or kw != want_kw:
        raise ValueError(f"bc_fused: xb {tuple(xb.shape)} and {wr.dtype} "
                         f"planes {tuple(wr.shape)} do not fit block size {k}")
    if ws1.shape != wr.shape or ws2.shape != wr.shape:
        raise ValueError("bc_fused: wr/ws1/ws2 must share one shape")
    if scales is not None and any(s.numel() != p for s in scales):
        raise ValueError(f"bc_fused: scales must hold one value per output "
                         f"block ({p})")
    if k > cc._DFT_MATMUL_MAX:
        raise ValueError(f"bc_fused: block size {k} > {cc._DFT_MATMUL_MAX}")
    cr, ci, dr, di = cc.dft_mats(k, device)
    y = torch.empty((B, p, k), device=device, dtype=torch.float32)
    planes = [ptr(wr), ptr(ws1), ptr(ws2)]
    if scales is not None:
        planes += [ptr(s) for s in scales]
    KERNEL.launch(lane, device, ptr(xb), *planes, ptr(cr), ptr(ci), ptr(dr),
                  ptr(di), ptr(y), B, p, q, k, rows_per_block(B), PTILE)
    return y
