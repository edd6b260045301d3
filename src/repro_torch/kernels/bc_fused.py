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

``plan`` cuts a call into tiles of rows shared by a thread-block cluster
(the source's head note says how); it is a pure function of the shapes,
so the CPU tests check it against the kernel's indexing.  ``dft_panel`` / ``dft_panel_t`` are the one DFT matrix the
kernel reads, and its transpose.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core import circulant as cc
from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = [_I] * 9                   # B, p, q, k, rows, cluster, mode, share, qc
KERNEL = Kernel("bc_fused", {"bc_fused": [_VP] * 7 + _PLAN,
                             "bc_fused_i8": [_VP] * 10 + _PLAN,
                             "bc_fused_i4": [_VP] * 10 + _PLAN})
# the exported function of each plane dtype (one lane each)
LANES = {torch.float32: "bc_fused", torch.int8: "bc_fused_i8",
         torch.uint8: "bc_fused_i4"}

# Launch-plan limits, as csrc/bc_fused.cu checks them.
MAX_SMEM = 232448          # bytes of shared memory a block can use (H100)
MAX_CLUSTER = 8            # portable thread-block cluster size
MAX_ROWS = 64              # rows per tile
SCRATCH_FLOATS = 3 * 2 * 256   # the decode MAC's partial sums (csrc)
P_SPLIT, Q_SPLIT = 0, 1    # cluster over output blocks / input blocks
# Clusters of each size that one H100 SXM runs at once, one block an SM
# (its 132 SMs sit in GPCs; 8-block clusters fit 15 times).  chip_smoke.py
# reads them on the card (cudaOccupancyMaxActiveClusters) and reports
# whether they match.
MAX_CLUSTERS = {8: 15, 4: 30, 2: 66, 1: 132}


class Plan(NamedTuple):
    """How one call is cut up: ``rows`` per tile; a cluster of ``cluster``
    blocks per tile; ``mode`` P_SPLIT (each block owns ``share`` output
    blocks, input blocks streamed ``qchunk`` at a time) or Q_SPLIT (each
    block owns ``share`` input blocks, the partial spectra summed over the
    cluster).  ``blocks`` and ``smem_bytes`` (per block) follow."""
    rows: int
    cluster: int
    mode: int
    share: int
    qchunk: int
    blocks: int
    smem_bytes: int


def ncols(k: int) -> int:
    """Columns of the DFT panel: 2 (k/2 + 1) rounded up to 8 (the mma's
    n)."""
    return (k + 2 + 7) // 8 * 8


def smem_bytes(p: int, q: int, k: int, rows: int, cluster: int, mode: int,
               share: int, qchunk: int) -> int:
    """Shared memory of one block (csrc/bc_fused.cu:layout): the panel
    (its transpose takes its place for a small iDFT), the staged input
    rows, the spectra, the Y accumulator, (Q_SPLIT) the summed Y and the
    decode MAC's scratch."""
    nc = ncols(k)
    ps = mode == P_SPLIT
    dft_rows = -(-rows * qchunk // cluster) if ps else rows * share
    idft_rows = rows * (share if ps else p)
    floats = (k * nc + dft_rows * (k + 4)
              + (rows * qchunk if ps else rows * share) * nc
              + idft_rows * (nc + 4)
              + (0 if ps else rows * p * (nc + 4)) + SCRATCH_FLOATS)
    return 4 * floats


def plan(B: int, p: int, q: int, k: int, lane: str = "bc_fused") -> Plan:
    """The launch plan of one call, a pure function of the shapes (the
    three lanes share it: the planes are read from device memory, never
    staged).  Each row's DFT is computed once, split over the cluster.
    Up to a wave of 8-block clusters (B <= 15, decode) a tile is one row
    and its cluster is as wide as it can be: 8 blocks over the output
    blocks, or over the input blocks where p < 4 (the k/v projections'
    p = 2).  Above that the cluster spans the output blocks, about two a
    block, from 2 to 8 blocks: narrower clusters fit more times on the
    card, and the k/v projections (p = 2 and 8) ran faster so on the
    H100.  Rows per tile are as few as fill whole waves of MAX_CLUSTERS
    clusters, up to 64; P_SPLIT streams the input
    blocks in the largest chunk that fits in shared memory, and a plan
    with chunks under 4 input blocks is taken only if no wave count gives
    one."""
    if lane not in LANES.values():
        raise ValueError(f"bc_fused: unknown lane {lane!r}")
    if k < 8 or k % 8:
        raise ValueError(f"bc_fused: block size {k} is not a multiple of 8 "
                         f"(the tensor-core tiles of the DFT)")
    if min(B, p, q) < 1:
        raise ValueError(f"bc_fused: empty shape B={B}, p={p}, q={q}")
    if B <= MAX_CLUSTERS[MAX_CLUSTER]:        # decode: one row a tile
        mode = P_SPLIT if p >= 4 else Q_SPLIT
        n = p if mode == P_SPLIT else q
        widest = n
    else:                                    # at least two output blocks
        mode, n = P_SPLIT, p                 # a block
        widest = min(p, max(2, p // 2))
    cluster = next(c for c in (8, 4, 2, 1) if c <= widest)
    share = -(-n // cluster)
    fallback = None
    for waves in range(1, 2 * B):
        rows = -(-B // (MAX_CLUSTERS[cluster] * waves))
        if rows > MAX_ROWS:
            continue
        for qc in (range(q, 0, -1) if mode == P_SPLIT else (q,)):
            smem = smem_bytes(p, q, k, rows, cluster, mode, share, qc)
            if smem <= MAX_SMEM:
                pl = Plan(rows, cluster, mode, share, qc,
                          -(-B // rows) * cluster, smem)
                if qc >= min(q, 4):
                    return pl
                fallback = fallback or pl
                break
        if rows == 1:
            break
    if fallback is not None:
        return fallback
    raise ValueError(f"bc_fused: no launch plan fits shared memory for "
                     f"p={p}, q={q}, k={k} ({MAX_SMEM} bytes a block)")


_PANELS: Dict[Tuple[int, str], torch.Tensor] = {}


def dft_panel_t(k: int, device) -> torch.Tensor:
    """The transpose of ``dft_panel`` (ncols(k), k), built once: the
    iDFT's matrix where it runs on the CUDA cores."""
    key = (-k, str(device))
    if key not in _PANELS:
        _PANELS[key] = dft_panel(k, device).t().contiguous()
    return _PANELS[key]


def dft_panel(k: int, device) -> torch.Tensor:
    """The DFT panel (k, ncols(k)) float32 on ``device``, built once: Cr
    and Ci interleaved per bin (columns 2f and 2f + 1), then zeros.  It is
    the one matrix both of the kernel's DFTs read (the irfft matrices are
    its transpose scaled per bin by 1/k or 2/k)."""
    key = (k, str(device))
    if key not in _PANELS:
        cr, ci, _, _ = cc.dft_mats(k, device)
        pair = torch.stack([cr, ci], dim=-1).reshape(k, -1)
        pad = torch.zeros((k, ncols(k) - pair.shape[1]), device=device)
        _PANELS[key] = torch.cat([pair, pad], dim=1).contiguous()
    return _PANELS[key]


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
    if xb.data_ptr() % 16:
        raise ValueError("bc_fused: xb must start 16-byte aligned (its rows "
                         "are staged with 16-byte asynchronous copies)")
    pl = plan(B, p, q, k, lane)
    y = torch.empty((B, p, k), device=device, dtype=torch.float32)
    planes = [ptr(wr), ptr(ws1), ptr(ws2)]
    if scales is not None:
        planes += [ptr(s) for s in scales]
    KERNEL.launch(lane, device, ptr(xb), *planes, ptr(dft_panel(k, device)),
                  ptr(dft_panel_t(k, device)), ptr(y), B, p, q, k, pl.rows,
                  pl.cluster, pl.mode, pl.share, pl.qchunk)
    return y
