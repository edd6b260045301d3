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
rows).  ``plan`` (row chunks, DFT column tiles, output tiles, row splits)
is a pure function of the shapes, checked by the CPU tests, which also
run the kernel's decomposition in plain PyTorch against ``repro``.

An MoE expert stack, gy (E, C, p, k) and xb (E, C, q, k) -> gw (E, p, q,
k), is one call (``repro``'s ``jax.vmap`` of the same ``gw``): every
expert runs the single call's plan at N = C, the expert index on the
kernels' grids, so expert e's result equals ``bc_grad_w(gy[e], xb[e])``
bit for bit; the experts go through in groups (``stack_group``) that keep
the scratch within ``CHUNK_BYTES``.  Its plain version is
``bc_grad_w_plain`` expert by expert.

The kernel works on packed spectra: bins 0 and k/2 are real, so they
share slot 0 (its two columns), and bin f in 1 .. k/2 - 1 takes slot f.
``packed_panel_t`` is the (k, k) matrix of that transform, rows in slot
order, and its transpose is the inverse's (each column weighted by 1/k or
2/k).  An odd k has no Nyquist bin: slot 0's second column is zeros, so it
has ``slots(k) = (k + 1) // 2`` slots and a (k + 1, k) matrix.

Block sizes that are multiples of 8 take the folded DFT on the tensor
cores; every other k >= 1 (up to 256) takes a plain DFT of each row on the
CUDA cores against ``packed_panel_t`` (``folded``), then the same
contraction and iDFT.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core import circulant as cc
from ..roofline.analysis import rfft_flops
from .build import Kernel, Work, address, cached, check_cuda, on_cpu, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
# gy, xb, folded panel, panel, spec, part, gw; N, p, q, k; chunk,
# dft_stages, dft_blocks, mt, nt, splits, mac_stages; E, group
KERNEL = Kernel("bc_grad_w", {"bc_grad_w": [_VP] * 7 + [_I] * 13})

# Launch-plan limits, as csrc/bc_grad_w.cu checks them.
MAX_SMEM = 232448          # bytes of shared memory a block can use (H100)
SM_SMEM = 233472           # bytes of shared memory an SM has (H100)
BLOCK_RESERVED = 1024      # bytes the runtime keeps for each block
SMS = 132
ROWS = 64                  # rows of N a contraction stage
CHUNK_ROWS = 128           # a chunk's rows are padded to this (csrc)
DFT_ROWS = 64              # rows of N a DFT tile (csrc: kDftRows)
MAX_UNITS = 8              # 16 x 8 output tiles a contraction warp holds
NT_CHOICES = (1, 2, 4, 8)  # 8-column tiles an output tile spans (csrc)
MAX_BINS = 132             # k / 2 + 1 at most: k up to 256
MAX_GRID_Y = 65535         # a CUDA grid's y: the contraction's output tiles
MAX_GRID_Z = 65535         # and its z: row splits times a group's experts
CHUNK_BYTES = 256 << 20    # the spectra scratch of one row chunk, at most


class Plan(NamedTuple):
    """How one call is cut up.  The rows go through in ``chunks`` of
    ``chunk`` rows: the DFT kernel writes a chunk's packed spectra to a
    scratch of ``spec_floats``, and the contraction kernel reads them
    back.  DFT: ``dft_blocks`` persistent blocks over the chunk's tiles of
    ``DFT_ROWS`` rows, ``dft_stages`` tiles in flight.
    Contraction: one block per (slot, output tile, split), an output tile
    ``mt`` 16-row tiles of output blocks by ``nt`` 8-column tiles of input
    blocks (``p_tiles`` x ``q_tiles`` of them), the chunk's rows cut into
    ``splits`` ranges whose partial sums (``part_floats``) are carried from
    chunk to chunk and added in split order by the iDFT kernel."""
    chunk: int
    chunks: int
    dft_stages: int
    dft_blocks: int
    dft_smem: int
    mt: int
    nt: int
    p_tiles: int
    q_tiles: int
    splits: int
    mac_stages: int
    mac_blocks: int
    mac_smem: int
    spec_floats: int
    part_floats: int


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slots(k: int) -> int:
    """Packed slots of block size k: bins 0 and k/2 share slot 0 (an odd
    k's slot 0 holds bin 0 and zeros), then one slot a bin."""
    return (k + 1) // 2


def folded(k: int) -> bool:
    """Whether the DFT runs folded on the tensor cores (k a multiple of 8)
    or as plain dot products on the CUDA cores."""
    return k % 8 == 0


def fold_len(k: int) -> int:
    """Positions of each of the four folded groups of a row: k/4 rounded
    up to 8 (the mma's k)."""
    return cdiv(k // 4, 8) * 8


def fold_rows(k: int) -> int:
    """Rows of each of the four folded sub-panels: k/4 rounded up to 16
    (the mma's m)."""
    return cdiv(k // 4, 16) * 16


def dft_smem(k: int, stages: int) -> int:
    """The four folded sub-panels (rows of fold_len + 4 floats) and
    ``stages`` tiles of ``DFT_ROWS`` rows, each folded in place (rows of
    max(k, 4 fold_len) + 4 floats) (csrc/bc_grad_w.cu:dft_kernel): at most
    202,752 bytes, at k = 256 and two stages.  A k that does not fold
    stages one tile of rows of k + 1 floats (dft_any_kernel)."""
    if not folded(k):
        return 4 * DFT_ROWS * (k + 1)
    L = fold_len(k)
    return 4 * (4 * fold_rows(k) * (L + 4)
                + stages * DFT_ROWS * (max(k, 4 * L) + 4))


def mac_smem(p_rows: int, q_rows: int, stages: int, units: int) -> int:
    """``stages`` stages of the output tile's spectra rows (both planes,
    ROWS + 4 floats a row), or the warps' partial sums at the end, whichever
    is larger (csrc/bc_grad_w.cu:mac_kernel)."""
    return 4 * max(stages * 2 * (p_rows + q_rows) * (ROWS + 4),
                   8 * units * 32 * 8)


def per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that share an SM (at most 2: the launch
    bounds)."""
    return max(1, min(2, SM_SMEM // (smem + BLOCK_RESERVED)))


def output_tiles(p: int, q: int) -> Tuple[int, int, int, int]:
    """(mt, nt, p_tiles, q_tiles): the output tile whose spectra rows read
    over all tiles, ``q_tiles p + p_tiles q``, are fewest, then the least
    padding, then the narrowest."""
    best = None
    for nt in NT_CHOICES:
        mt_max = MAX_UNITS // nt
        mts, nts = cdiv(p, 16), cdiv(q, 8)
        p_tiles = cdiv(mts, mt_max)
        mt = cdiv(mts, p_tiles)
        q_tiles = cdiv(nts, nt)
        key = (q_tiles * p + p_tiles * q, p_tiles * q_tiles * mt * nt, nt)
        if best is None or key < best[0]:
            best = (key, (mt, nt, p_tiles, q_tiles))
    return best[1]


def plan(N: int, p: int, q: int, k: int,
         chunk: Optional[int] = None) -> Plan:
    """The launch plan of one call, a pure function of the shapes.
    ``chunk`` (rows a chunk, rounded up to 128) replaces the plan's own
    row chunks, which are as long as a scratch of ``CHUNK_BYTES`` allows
    (``tools/grad_w_sweep.py --chunks`` times other lengths)."""
    if k < 1:
        raise ValueError(f"bc_grad_w: block size {k}")
    if min(N, p, q) < 1:
        raise ValueError(f"bc_grad_w: empty shape N={N}, p={p}, q={q}")
    if k // 2 + 1 > MAX_BINS:
        raise ValueError(f"bc_grad_w: block size {k} has {k // 2 + 1} bins, "
                         f"more than the kernel's {MAX_BINS}")
    mt, nt, p_tiles, q_tiles = output_tiles(p, q)
    if p_tiles * q_tiles > MAX_GRID_Y:
        raise ValueError(f"bc_grad_w: {p} x {q} blocks make {p_tiles} x "
                         f"{q_tiles} output tiles, more than a grid's "
                         f"{MAX_GRID_Y}")
    # the deepest ring that keeps as many blocks an SM as two stages do
    stages = max(s for s in (2, 3, 4) if dft_smem(k, s) <= MAX_SMEM
                 and per_sm(dft_smem(k, s)) == per_sm(dft_smem(k, 2)))
    d_smem = dft_smem(k, stages)
    fam, cols = p + q, 2 * slots(k)
    if chunk is None:
        per_chunk = max(1, CHUNK_BYTES // (4 * cols * fam * CHUNK_ROWS))
        chunk = cdiv(N, cdiv(N, CHUNK_ROWS * per_chunk))
    chunk = cdiv(chunk, CHUNK_ROWS) * CHUNK_ROWS
    p_rows, q_rows = min(16 * mt, p), min(8 * nt, q)
    units = mt * nt
    m_stages = 3 if per_sm(mac_smem(p_rows, q_rows, 3, units)) == 2 else 2
    m_smem = mac_smem(p_rows, q_rows, m_stages, units)
    S = slots(k)
    wave = SMS * per_sm(m_smem) // (S * p_tiles * q_tiles)
    per = cdiv(chunk // ROWS, max(1, wave))
    splits = cdiv(chunk // ROWS, per)
    return Plan(chunk=chunk, chunks=cdiv(N, chunk), dft_stages=stages,
                dft_blocks=SMS * per_sm(d_smem), dft_smem=d_smem, mt=mt,
                nt=nt, p_tiles=p_tiles, q_tiles=q_tiles, splits=splits,
                mac_stages=m_stages,
                mac_blocks=S * p_tiles * q_tiles * splits,
                mac_smem=m_smem, spec_floats=cols * fam * chunk,
                part_floats=splits * S * p * q * 2)


def stack_group(E: int, pl: Plan) -> int:
    """Experts a group of an E-expert stack's call takes at once, each on
    ``pl`` (one expert's plan): as many as keep the group's spectra and
    partial sums within ``CHUNK_BYTES`` each and its contraction grid's z
    (splits x experts) within ``MAX_GRID_Z``, at least one, evened out
    over the groups.  At llama4's experts (E = 128, C = 80 rows, up/gate
    p = 64, q = 40, k = 128: 6.8 MB of spectra an expert) four groups of
    32."""
    most = CHUNK_BYTES // (4 * max(pl.spec_floats, pl.part_floats))
    most = max(1, min(E, most, MAX_GRID_Z // pl.splits))
    return cdiv(E, cdiv(E, most))


def shape_key(N: int, p: int, q: int, k: int, E: int = 1) -> str:
    """A launch's shape as ``Kernel.shape_launches`` counts it: one
    projection's N x p x q x k, an expert stack's E x C x p x q x k."""
    lead = f"{E}x" if E > 1 else ""
    return f"bc_grad_w/{lead}{N}x{p}x{q}x{k}"


def work(N: int, p: int, q: int, k: int, E: int = 1,
         chunk: Optional[int] = None) -> Work:
    """What one call over E experts of N rows does: bytes are each input
    read once and the output written once; operations the two input
    real FFTs (``rfft_flops``: 2.5 k log2 k each), the Gauss MAC (3
    products and 3 sums a row, pair and bin, as ``bc_fused`` counts it)
    with its operand sums, its two output sums, and the inverse FFTs; the
    scratch is what the wrapper allocates beside ``gw``: a group of
    experts' spectra and partial sums (``plan``, ``stack_group``)."""
    kf = k // 2 + 1
    pl = plan(N, p, q, k, chunk)
    nbytes = 4 * E * (N * p * k + N * q * k + p * q * k)
    flops = E * (rfft_flops(N * p, k) + rfft_flops(N * q, k)
                 + 6 * N * p * q * kf + N * p * kf + 2 * N * q * kf
                 + 2 * p * q * kf + rfft_flops(p * q, k))
    group = stack_group(E, pl)
    return Work(flops, nbytes,
                4 * group * (pl.spec_floats + pl.part_floats))


def launch_work(fn: str, ints: Sequence) -> Work:
    """``work`` of a launch from its integer arguments (N, p, q, k, the
    plan's chunk ..., E, group): the stand-in's count
    (``kernels/standin.py``)."""
    N, p, q, k, chunk = ints[:5]
    return work(N, p, q, k, ints[11], chunk)


_PANELS: Dict[Tuple[str, int, str], torch.Tensor] = {}


def packed_panel_t(k: int, device) -> torch.Tensor:
    """The packed real DFT P (2 slots(k), k) float32 on ``device``, built
    once, rows in slot order: Cr's bin 0 and bin k/2 columns (an odd k:
    zeros in place of the second), then Cr and Ci of each bin 1 ..
    kf - 1 below k/2.  The inverse of packed spectra u (..., 2 slots(k))
    is ``(u * w) @ P`` with w = 1/k on columns 0 and 1, 2/k on the
    others."""
    return cached(_PANELS, ("packed", k, str(device)),
                  lambda: _packed_panel_t(k, device))


def _packed_panel_t(k: int, device) -> torch.Tensor:
    cr, ci, _, _ = cc.dft_mats(k, "cpu")
    rows = [cr[:, 0], cr[:, k // 2] if k % 2 == 0 else torch.zeros(k)]
    for f in range(1, slots(k)):
        rows += [cr[:, f], ci[:, f]]
    return torch.stack(rows).contiguous().to(device)


def dft_panel(k: int, device) -> torch.Tensor:
    """The folded DFT sub-panels (4, fold_rows(k), fold_len(k)) float32 on
    ``device``, built once.  With h = k/2, s_t = x_t + x_{k-t} and d_t =
    x_t - x_{k-t} (s_0 = x_0, s_h = x_h), row f of each multiplies one
    group of a row's folded values (csrc/bc_grad_w.cu, "Folding"):
    0: Cr[t, f] over s_t, t = 0, 2, .. h - 2;  1: Cr[t, f] over s_t, t
    odd;  2: Ci[t, f] over d_t, t = 2, 4, .. h - 2;  3: Ci[t, f] over d_t,
    t odd, for f < h/2 (rows 2 and 3 from f = 1), and row 0 of sub-panel
    3 is Ci[t, h/2] (bin h/2's sine part)."""
    return cached(_PANELS, ("folded", k, str(device)),
                  lambda: _dft_panel(k, device))


def _dft_panel(k: int, device) -> torch.Tensor:
    cr, ci, _, _ = cc.dft_mats(k, "cpu")
    h, hh = k // 2, k // 4
    f_ = torch.zeros((4, fold_rows(k), fold_len(k)), dtype=torch.float32)
    for f in range(hh):
        f_[0, f, :hh] = cr[0:h:2, f]
        f_[1, f, :hh] = cr[1:h:2, f]
        if f:
            f_[2, f, :hh - 1] = ci[2:h:2, f]
            f_[3, f, :hh] = ci[1:h:2, f]
    f_[3, 0, :hh] = ci[1:h:2, hh]
    return f_.contiguous().to(device)


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


def bc_grad_w(gy: torch.Tensor, xb: torch.Tensor, k: int,
              chunk: Optional[int] = None) -> torch.Tensor:
    """gy (N, p, k), xb (N, q, k) float32 -> gw (p, q, k) float32, or an
    expert stack gy (E, C, p, k), xb (E, C, q, k) -> gw (E, p, q, k) in
    one call; ``chunk`` as ``plan`` takes it."""
    stacked = gy.dim() == 4
    if on_cpu(gy):
        if stacked:
            return torch.stack([bc_grad_w_plain(gy[e], xb[e], k)
                                for e in range(gy.shape[0])])
        return bc_grad_w_plain(gy, xb, k)
    device = check_cuda("bc_grad_w", {"gy": gy, "xb": xb},
                        {"gy": (torch.float32,), "xb": (torch.float32,)})
    rank = 3 + stacked
    if gy.dim() != rank or xb.dim() != rank or (
            gy.shape[:-2] != xb.shape[:-2]) or (
            gy.shape[-1] != k or xb.shape[-1] != k):
        raise ValueError(f"bc_grad_w: gy {tuple(gy.shape)} and xb "
                         f"{tuple(xb.shape)} are not ([E,] N, p, {k}) and "
                         f"([E,] N, q, {k})")
    if folded(k) and (address(gy) | address(xb)) % 16:
        raise ValueError("bc_grad_w: gy and xb must start 16-byte aligned")
    E = gy.shape[0] if stacked else 1
    N, p, _ = gy.shape[-3:]
    q = xb.shape[-2]
    pl = plan(N, p, q, k, chunk)
    group = stack_group(E, pl)
    spec = torch.empty(group * pl.spec_floats, device=device,
                       dtype=torch.float32)
    part = torch.empty(group * pl.part_floats, device=device,
                       dtype=torch.float32)
    gw = torch.empty((*gy.shape[:-3], p, q, k), device=device,
                     dtype=torch.float32)
    fold = dft_panel(k, device) if folded(k) else None   # unread otherwise
    panel = packed_panel_t(k, device)
    KERNEL.launch("bc_grad_w", device, ptr(gy), ptr(xb),
                  ptr(panel if fold is None else fold), ptr(panel),
                  ptr(spec), ptr(part), ptr(gw), N, p, q, k, pl.chunk,
                  pl.dft_stages, pl.dft_blocks, pl.mt, pl.nt, pl.splits,
                  pl.mac_stages, E, group,
                  path="experts" if stacked else "single",
                  shape=shape_key(N, p, q, k, E))
    return gw
