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

The paper's own MAC, without the Gauss trick (``gauss_trick=False``), is
a second set of the same three lanes on the two planes wr, wi
(``bc_fused4_matmul``; ``LANES4``): Yr = Σ (Xr wr - Xi wi), Yi = Σ (Xr wi +
Xi wr), each quantized plane's row scale folded into its own terms as
``repro``'s ``_naive_complex_contract`` folds them.  It shares the DFT
panel and the plan with the Gauss lanes; its MAC loads two planes and keeps
four sums, so the decode MAC's scratch holds four floats a work item
(``smem_bytes(..., sums=4)``).  Its plain version is that 4-product
contraction (``bc_fused4_matmul_plain``).

An expert stack (xb (E, B, q, k), planes (E, p, q, kf), scales (E, p, 1))
is one launch: the kernel puts the expert index on its grid and reads each
expert's rows, planes and scales at its stride (``launch_args``), with one
expert's plan, so the result equals the per-expert calls bit for bit.  On
the CPU the stack runs the plain version expert by expert.

``plan`` cuts a call into tiles of rows shared by a thread-block cluster
(the source's head note says how); it is a pure function of the shapes,
so the CPU tests check it against the kernel's indexing.  ``dft_panel`` / ``dft_panel_t`` are the one DFT matrix the
kernel reads, and its transpose.

Every block size k >= 1 has a plan.  The kernel's products tile k in 8s,
so a k that is not a multiple of 8 (4, 5, 12, ...) runs them over ``kpad(k)``
columns: the panel's extra rows are zeros, as are the staged rows' extra
columns, so the transform is still the length-k DFT.  A panel past
``PANEL_FLOATS`` (k >= 184; k = 256 would take 264 KB of the 227 KB a block
has) is read from device memory instead of shared memory
(``panel_staged``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core import circulant as cc
from ..roofline.analysis import rfft_flops
from .build import Kernel, Work, address, cached, check_cuda, on_cpu, ptr

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# B, p, q, k, rows, cluster, mode, share, qc; E and the expert strides
# (x, plane, scales, y)
_PLAN = [_I] * 10 + [_LL] * 4
KERNEL = Kernel("bc_fused", {"bc_fused": [_VP] * 7 + _PLAN,
                             "bc_fused_i8": [_VP] * 10 + _PLAN,
                             "bc_fused_i4": [_VP] * 10 + _PLAN,
                             "bc_fused4": [_VP] * 6 + _PLAN,
                             "bc_fused4_i8": [_VP] * 8 + _PLAN,
                             "bc_fused4_i4": [_VP] * 8 + _PLAN})
# the exported function of each plane dtype (one lane each): the Gauss
# MAC's, and the 4-product MAC's
LANES = {torch.float32: "bc_fused", torch.int8: "bc_fused_i8",
         torch.uint8: "bc_fused_i4"}
LANES4 = {torch.float32: "bc_fused4", torch.int8: "bc_fused4_i8",
          torch.uint8: "bc_fused4_i4"}

# Launch-plan limits, as csrc/bc_fused.cu checks them.
MAX_SMEM = 232448          # bytes of shared memory a block can use (H100)
MAX_CLUSTER = 8            # portable thread-block cluster size
MAX_ROWS = 64              # rows per tile
SCRATCH_FLOATS = 2 * 256   # the decode MAC's partial sums, a sum (csrc)
PANEL_FLOATS = 32768       # a larger DFT panel is not staged (csrc)
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


def kpad(k: int) -> int:
    """Rows of the DFT panel: k rounded up to 8 (the mma's k); rows past k
    are zeros."""
    return (k + 7) // 8 * 8


def panel_staged(k: int) -> bool:
    """Whether the kernel stages the (kpad(k), ncols(k)) panel in shared
    memory (up to 128 KiB; k <= 176), or reads it from device memory."""
    return kpad(k) * ncols(k) <= PANEL_FLOATS


def sums(lane: str) -> int:
    """Sums a MAC thread keeps: 3 on a Gauss lane, 4 on a 4-product one."""
    return 4 if lane in LANES4.values() else 3


def smem_bytes(p: int, q: int, k: int, rows: int, cluster: int, mode: int,
               share: int, qchunk: int, sums: int = 3) -> int:
    """Shared memory of one block (csrc/bc_fused.cu:layout): the panel
    (its transpose takes its place for a small iDFT), the staged input
    rows, the spectra, the Y accumulator, (Q_SPLIT) the summed Y and the
    decode MAC's scratch (``sums`` floats a work item)."""
    nc, kp = ncols(k), kpad(k)
    ps = mode == P_SPLIT
    dft_rows = -(-rows * qchunk // cluster) if ps else rows * share
    idft_rows = rows * (share if ps else p)
    floats = ((kp * nc if panel_staged(k) else 0) + dft_rows * (kp + 4)
              + (rows * qchunk if ps else rows * share) * nc
              + idft_rows * (nc + 4)
              + (0 if ps else rows * p * (nc + 4)) + sums * SCRATCH_FLOATS)
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
    one.  Any block size k >= 1 plans (module docstring)."""
    if lane not in (*LANES.values(), *LANES4.values()):
        raise ValueError(f"bc_fused: unknown lane {lane!r}")
    nsum = sums(lane)
    if k < 1:
        raise ValueError(f"bc_fused: block size {k}")
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
            smem = smem_bytes(p, q, k, rows, cluster, mode, share, qc, nsum)
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


def launch_args(B: int, p: int, q: int, k: int, lane: str = "bc_fused",
                E: int = 1) -> Tuple[int, ...]:
    """The integer arguments of one launch over E experts of B rows each,
    a pure function of the shapes: the shape and one expert's plan (B, p,
    q, k, rows, cluster, mode, share, qchunk), then E and the strides
    between experts of contiguous stacks, each in its tensor's elements:
    xb (B q k), a plane (p q kf; the int4 lane's packed bytes), a scale
    vector (p), y (B p k).  E = 1 is a single product."""
    pl = plan(B, p, q, k, lane)
    kf = k // 2 + 1
    row = (kf + 1) // 2 if lane.endswith("_i4") else kf
    return (B, p, q, k, pl.rows, pl.cluster, pl.mode, pl.share, pl.qchunk,
            E, B * q * k, p * q * row, p, B * p * k)


_PANELS: Dict[Tuple[int, str], torch.Tensor] = {}


def shape_key(E: int, B: int, p: int, q: int, k: int, lane: str) -> str:
    """A launch's shape (E experts of B rows, p x q blocks of k) and lane
    as ``Kernel.shape_launches`` counts it."""
    return f"{lane}/{E}x{B}x{p}x{q}x{k}"


def plane_row_bytes(k: int, lane: str) -> int:
    """Bytes of one plane row (kf bins) on ``lane``: float32, int8, or
    packed int4 (two bins a byte, kf padded to even)."""
    kf = k // 2 + 1
    if lane.endswith("_i4"):
        return (kf + 1) // 2
    return kf if lane.endswith("_i8") else 4 * kf


def work(E: int, B: int, p: int, q: int, k: int,
         lane: str = "bc_fused") -> Work:
    """What one launch over E experts of B rows (p x q blocks of k) does
    on ``lane``: bytes are the input and the output once, the planes (3 on
    a Gauss lane, 2 on a 4-product one) and, quantized, their scales; the
    DFT panel is not counted (a function of k alone, which a kernel could
    make from k twiddles in registers).  Operations: the input and output
    real FFTs (``rfft_flops``: 2.5 k log2 k each), the MAC (Gauss: 3
    products and 3 sums a row, pair and bin, one operand sum a row, input
    block and bin, two output sums a row, output block and bin;
    4-product: 4 products and 4 sums, two combines) and, quantized, a
    scale fold a plane, row, output block and bin.  No scratch: the
    wrapper allocates the output alone."""
    kf = k // 2 + 1
    n = sums(lane)                       # planes read: 3 (Gauss), 2
    planes = 3 if n == 3 else 2
    scaled = not (lane in (LANES[torch.float32], LANES4[torch.float32]))
    nbytes = E * (4 * (B * q * k + B * p * k)
                  + planes * p * q * plane_row_bytes(k, lane)
                  + (planes * 4 * p if scaled else 0))
    mac = (6 * B * p * q * kf + B * q * kf + 2 * B * p * kf if n == 3
           else 8 * B * p * q * kf + 2 * B * p * kf)
    flops = E * (rfft_flops(B * q, k) + mac + rfft_flops(B * p, k)
                 + (n * B * p * kf if scaled else 0))
    return Work(flops, nbytes, 0)


def launch_work(fn: str, ints: Sequence) -> Work:
    """``work`` of a launch from its integer arguments (``launch_args``:
    B, p, q, k, the plan, then E): the stand-in's count
    (``kernels/standin.py``)."""
    B, p, q, k = ints[:4]
    return work(ints[9], B, p, q, k, fn)


def dft_panel_t(k: int, device) -> torch.Tensor:
    """The transpose of ``dft_panel`` (ncols(k), kpad(k)), built once: the
    iDFT's matrix where it runs on the CUDA cores, or where the panel is
    read from device memory."""
    return cached(_PANELS, (-k, str(device)),
                  lambda: dft_panel(k, device).t().contiguous())


def dft_panel(k: int, device) -> torch.Tensor:
    """The DFT panel (kpad(k), ncols(k)) float32 on ``device``, built once:
    Cr and Ci interleaved per bin (columns 2f and 2f + 1), then zeros, and
    zero rows past k.  It is the one matrix both of the kernel's DFTs read
    (the irfft matrices are its transpose scaled per bin by 1/k or 2/k)."""
    def make():
        cr, ci, _, _ = cc.dft_mats(k, device)
        pair = torch.stack([cr, ci], dim=-1).reshape(k, -1)
        panel = torch.zeros((kpad(k), ncols(k)), device=device)
        panel[:k, :pair.shape[1]] = pair
        return panel.contiguous()
    return cached(_PANELS, (k, str(device)), make)


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


def bc_fused4_matmul_plain(xb: torch.Tensor, wr: torch.Tensor,
                           wi: torch.Tensor, k: int,
                           scales: Optional[Sequence[torch.Tensor]] = None
                           ) -> torch.Tensor:
    """Plain version of the 4-product lane: ``repro``'s
    ``bc_matmul_spectral`` without the Gauss planes
    (``_naive_complex_contract``) on blockified float32 input.
    xb (B, q, k) -> (B, p, k)."""
    cache = {"wr": wr, "wi": wi}
    if scales is not None:
        cache.update(zip(("wr_s", "wi_s"), scales))
    xr, xi = cc.rfft_planes(xb, k)
    yr, yi = cc._naive_complex_contract(xr, xi, cache, "bqf,pqf->bpf")
    return cc.irfft_planes(yr, yi, k)


def _on_cpu(plain, xb, planes, k, scales):
    """The plain version on the CPU, expert by expert for a stack."""
    if xb.dim() == 3:
        return plain(xb, *planes, k, scales)
    return torch.stack([plain(
        xb[e], *(w[e] for w in planes), k,
        None if scales is None else [s[e] for s in scales])
        for e in range(xb.shape[0])])


def bc_fused_matmul(xb: torch.Tensor, wr: torch.Tensor, ws1: torch.Tensor,
                    ws2: torch.Tensor, k: int,
                    scales: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """xb: (B, q, k) float32; planes (p, q, k//2+1) float32, or int8 / packed
    uint8 with ``scales`` = (s_wr, s_ws1, s_ws2), each (p, 1) float32
    -> (B, p, k) float32.  An expert stack adds a leading E to every
    operand: xb (E, B, q, k), planes (E, p, q, ·), scales (E, p, 1) ->
    (E, B, p, k), expert e's rows against its own planes."""
    if on_cpu(xb):
        return _on_cpu(bc_fused_matmul_plain, xb, (wr, ws1, ws2), k, scales)
    return _launch(LANES, xb, {"wr": wr, "ws1": ws1, "ws2": ws2}, k, scales)


def bc_fused4_matmul(xb: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                     k: int, scales: Optional[Sequence[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """The 4-product lane (``gauss_trick=False``): as ``bc_fused_matmul``
    on the planes wr, wi and, quantized, ``scales`` = (s_wr, s_wi)."""
    if on_cpu(xb):
        return _on_cpu(bc_fused4_matmul_plain, xb, (wr, wi), k, scales)
    return _launch(LANES4, xb, {"wr": wr, "wi": wi}, k, scales)


def _launch(lanes: Dict[torch.dtype, str], xb: torch.Tensor,
            planes: Dict[str, torch.Tensor], k: int,
            scales: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Check the operands of one product or stack on the card and launch
    the lane of ``lanes`` that the planes' dtype names."""
    stacked = xb.dim() == 4
    wr = planes["wr"]
    lane = lanes.get(wr.dtype)
    tensors = {"xb": xb, **planes}
    dtypes = {"xb": (torch.float32,)}
    dtypes.update({n: (wr.dtype,) for n in planes})
    snames = [f"s_{n}" for n in planes]
    if scales is not None:
        tensors.update(zip(snames, scales))
        dtypes.update({n: (torch.float32,) for n in snames})
    device = check_cuda("bc_fused", tensors, dtypes)
    if lane is None or (scales is None) != (wr.dtype == torch.float32):
        raise ValueError(f"bc_fused: planes of dtype {wr.dtype} "
                         f"{'with' if scales is not None else 'without'} "
                         f"scales; expected float32 planes without scales "
                         f"or int8 / uint8 planes with them")
    E = xb.shape[0] if stacked else 1
    lead = (E,) if stacked else ()
    if xb.dim() != 3 + stacked or wr.dim() != 3 + stacked or (
            stacked and wr.shape[0] != E):
        raise ValueError(f"bc_fused: xb {tuple(xb.shape)} and planes "
                         f"{tuple(wr.shape)} are not one product or one "
                         f"stack of {E} experts")
    B, q, kx = xb.shape[-3:]
    p, qw, kw = wr.shape[-3:]
    kf = k // 2 + 1
    want_kw = (kf + 1) // 2 if wr.dtype == torch.uint8 else kf
    if kx != k or qw != q or kw != want_kw:
        raise ValueError(f"bc_fused: xb {tuple(xb.shape)} and {wr.dtype} "
                         f"planes {tuple(wr.shape)} do not fit block size {k}")
    if any(w.shape != wr.shape for w in planes.values()):
        raise ValueError(f"bc_fused: the planes {'/'.join(planes)} must "
                         f"share one shape")
    if scales is not None and (len(scales) != len(planes) or any(
            s.numel() != E * p for s in scales)):
        raise ValueError(f"bc_fused: one scale vector a plane, each one "
                         f"value per output block ({p}) and expert ({E})")
    if k % 8 == 0 and address(xb) % 16:
        raise ValueError("bc_fused: xb must start 16-byte aligned (its rows "
                         "are staged with 16-byte asynchronous copies)")
    y = torch.empty((*lead, B, p, k), device=device, dtype=torch.float32)
    ptrs = [ptr(w) for w in planes.values()]
    if scales is not None:
        ptrs += [ptr(s) for s in scales]
    KERNEL.launch(lane, device, ptr(xb), *ptrs, ptr(dft_panel(k, device)),
                  ptr(dft_panel_t(k, device)), ptr(y),
                  *launch_args(B, p, q, k, lane, E),
                  path="experts" if stacked else "single",
                  shape=shape_key(E, B, p, q, k, lane))
    return y
