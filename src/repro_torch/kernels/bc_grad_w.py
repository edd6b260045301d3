"""The weight gradient of a block-circulant projection (``csrc/bc_grad_w.cu``).

    gw[i, j, :] = irfft_k( Σ_n Gf[n, i, :] ∘ conj(Xf[n, j, :]) )

for the output gradient ``gy`` (N, p, k) and the blockified input ``xb``
(N, q, k), both float32 -> ``gw`` (p, q, k) float32.  It is the ``gw``
half of ``repro``'s hand-derived backward (``core/circulant.py:
_bc_fft_bwd``, the paper's Eqn. 3), which ``repro`` leaves to XLA: no
Pallas kernel computes it, and this is a kernel of the port's own.

``bc_grad_w`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``bc_grad_w_plain``, ``repro``'s math in
plain PyTorch (DFT products against ``dft_mats``, then ``einsum`` over the
rows).  ``plan`` (tile shape and row splits) is a pure function of the
shapes, checked by the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import circulant as cc
from .bc_fused import dft_panel, dft_panel_t, ncols
from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
# gy, xb, panel, panel_t, part, gw; N, p, q, k, pt, qt, splits, rows
KERNEL = Kernel("bc_grad_w", {"bc_grad_w": [_VP] * 6 + [_I] * 8})

# Launch-plan limits, as csrc/bc_grad_w.cu checks them.
MAX_SMEM = 232448          # bytes of shared memory a block can use (H100)
MAX_PAIRS = 64             # (output block, input block) pairs a block
ROWS = 4                   # rows of N a chunk (csrc kRows)
SMS = 132                  # one block an SM: the row splits fill one wave


class Plan(NamedTuple):
    """Tiles of ``pt`` output x ``qt`` input blocks; the N rows cut into
    ``splits`` ranges of ``rows``; ``blocks`` of the first launch and its
    shared memory a block."""
    pt: int
    qt: int
    splits: int
    rows: int
    blocks: int
    smem_bytes: int


def smem_bytes(k: int, pt: int, qt: int) -> int:
    """The panel, a chunk's raw rows (stride k + 4) and their spectra
    (csrc/bc_grad_w.cu:layout)."""
    rows = ROWS * (pt + qt)
    return 4 * (k * ncols(k) + rows * (k + 4) + rows * ncols(k))


def plan(N: int, p: int, q: int, k: int) -> Plan:
    """The tile whose DFT rows over the grid, ``ceil(q/qt) p + ceil(p/pt)
    q`` per row of N, are fewest (then the fewest tiles), and as many row
    splits as make one block an SM."""
    if k < 8 or k % 8:
        raise ValueError(f"bc_grad_w: block size {k} is not a multiple of 8")
    if min(N, p, q) < 1:
        raise ValueError(f"bc_grad_w: empty shape N={N}, p={p}, q={q}")
    if k // 2 + 1 > 4 * 33:
        raise ValueError(f"bc_grad_w: block size {k} has more bins than "
                         f"the kernel's registers hold")
    best = None
    for pt in range(1, min(p, MAX_PAIRS) + 1):
        qt = min(q, MAX_PAIRS // pt)
        tp, tq = -(-p // pt), -(-q // qt)
        key = (tq * p + tp * q, tp * tq, pt)
        if best is None or key < best[0]:
            best = (key, pt, qt, tp * tq)
    _, pt, qt, tiles = best
    smem = smem_bytes(k, pt, qt)
    if smem > MAX_SMEM:
        raise ValueError(f"bc_grad_w: block size {k} needs {smem} bytes of "
                         f"shared memory ({MAX_SMEM} a block)")
    splits = max(1, min(-(-SMS // tiles), -(-N // ROWS)))
    rows = -(-(-(-N // splits)) // ROWS) * ROWS
    splits = -(-N // rows)
    return Plan(pt, qt, splits, rows, tiles * splits, smem)


def shape_key(N: int, p: int, q: int, k: int) -> str:
    """A launch's shape as ``Kernel.shape_launches`` counts it."""
    return f"bc_grad_w/{N}x{p}x{q}x{k}"


def bc_grad_w_plain(gy: torch.Tensor, xb: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """``repro``'s ``gw``: ur = Σ gr xr + gi xi, ui = Σ gi xr - gr xi over
    the rows, then ``irfft_planes``.  gy (N, p, k), xb (N, q, k) ->
    (p, q, k)."""
    gr, gi = cc.rfft_planes(gy, k)
    xr, xi = cc.rfft_planes(xb, k)
    spec = "npf,nqf->pqf"
    ur = torch.einsum(spec, gr, xr) + torch.einsum(spec, gi, xi)
    ui = torch.einsum(spec, gi, xr) - torch.einsum(spec, gr, xi)
    return cc.irfft_planes(ur, ui, k)


def bc_grad_w(gy: torch.Tensor, xb: torch.Tensor, k: int) -> torch.Tensor:
    """gy (N, p, k), xb (N, q, k) float32 -> gw (p, q, k) float32."""
    if gy.device.type == "cpu":
        return bc_grad_w_plain(gy, xb, k)
    device = check_cuda("bc_grad_w", {"gy": gy, "xb": xb},
                        {"gy": (torch.float32,), "xb": (torch.float32,)})
    if gy.dim() != 3 or xb.dim() != 3 or gy.shape[0] != xb.shape[0] or (
            gy.shape[2] != k or xb.shape[2] != k):
        raise ValueError(f"bc_grad_w: gy {tuple(gy.shape)} and xb "
                         f"{tuple(xb.shape)} are not (N, p, {k}) and "
                         f"(N, q, {k})")
    if (gy.data_ptr() | xb.data_ptr()) % 16:
        raise ValueError("bc_grad_w: gy and xb must start 16-byte aligned")
    N, p, _ = gy.shape
    q = xb.shape[1]
    pl = plan(N, p, q, k)
    part = torch.empty((pl.splits, p, q, k + 2), device=device,
                       dtype=torch.float32)
    gw = torch.empty((p, q, k), device=device, dtype=torch.float32)
    KERNEL.launch("bc_grad_w", device, ptr(gy), ptr(xb),
                  ptr(dft_panel(k, device)), ptr(dft_panel_t(k, device)),
                  ptr(part), ptr(gw), N, p, q, k, pl.pt, pl.qt, pl.splits,
                  pl.rows, shape=shape_key(N, p, q, k))
    return gw
