"""The frequency-domain MAC on its own: per bin f, ``Y[f] = X[f] · W[f]``
as three real products (Gauss).

Port of ``repro/kernels/spectral_matmul.py``, with its signature and
logical shapes.  ``spectral_matmul`` is the wrapper: on CUDA tensors it
launches ``csrc/spectral_matmul.cu`` (or raises), on CPU tensors it runs
``spectral_matmul_plain``, the three real products batched over F in plain
PyTorch (``repro/kernels/ref.py:spectral_matmul_ref`` with
``wi = ws1 + wr``).  There is no other fallback.

    xr/xi (F, B, Q), wr/ws1/ws2 (F, Q, P)  ->  yr/yi (F, B, P)
    t1 = (xr + xi)·wr,  t2 = xr·ws1,  t3 = xi·ws2
    yr = t1 - t3,       yi = t1 + t2

The operands are read through their strides, in one of two layouts
(``layout_of``): ``BIN_MAJOR``, every operand contiguous (``repro``'s), or
``BIN_MINOR``, the views ``kernels/ops.py:spectral_contract`` passes
without a copy, X strides (1, Q·F, F) and W strides (1, F, Q·F).  The
outputs take X's layout: in ``BIN_MINOR`` they are (F, B, P) views of
contiguous (B, P, F) buffers.  Any other layout raises; nothing is copied
into one.  ``plan`` is the launch plan, a pure function of the shapes and
the layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .build import Kernel, Work, check_cuda, on_cpu, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
# F, N, Q, P, layout, then the plan: chunks, fc, rows, stages, jn, splits
KERNEL = Kernel("spectral_matmul", {"spectral_matmul": [_VP] * 7 + [_I] * 11})

BIN_MAJOR, BIN_MINOR = 0, 1
LAYOUT_NAMES = {BIN_MAJOR: "bin-major", BIN_MINOR: "bin-minor"}
# Launch-plan limits, as csrc/spectral_matmul.cu checks them.
MAX_SMEM = 232448          # bytes of shared memory a block can use (H100)
SM_SMEM = 233472           # bytes of shared memory an SM has for blocks
SMEM_RESERVED = 1024       # bytes the runtime keeps a block
SMS = 132                  # streaming multiprocessors of an H100
THREADS = 256
WARPS = THREADS // 32
ROWS = (16, 32, 64)        # rows a tile: 1, 2 or 4 mma tiles
MAX_J = 2                  # 8-column tiles a warp unit
FCS = (16, 8, 4, 2, 1)     # bins a chunk, widest first
MAX_GRID_Y = 65535


class SpectralPlan(NamedTuple):
    """How one call is cut up: ``chunks`` chunks of at most ``fc`` bins
    (grid x; bins balanced to within one), each block over every
    ``splits``-th row tile of ``ROWS`` rows (grid y); an X ring of
    ``stages`` tiles; warp units of ``jn`` 8-column tiles (the P tile is
    ``8 jn``); ``smem_bytes`` a block; ``per_sm`` blocks an SM (shared
    memory); ``path``: the tensor cores (3xTF32 ``mma.sync``)."""
    layout: int
    chunks: int
    splits: int
    fc: int
    rows: int
    stages: int
    jn: int
    smem_bytes: int
    per_sm: int
    path: str = "mma_3xtf32"

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.chunks, self.splits)

    @property
    def block(self) -> int:
        return THREADS

    @property
    def p_tile(self) -> int:
        return 8 * self.jn


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def smem_bytes(Q: int, P: int, layout: int, fc: int, rows: int,
               stages: int) -> int:
    """Shared memory of one block (csrc/spectral_matmul.cu:geometry): the
    chunk's three planes (qp x ldb a bin), the X ring (two planes of rows
    x lda a bin and stage) and the Y tiles: bin-minor, two planes of rows x
    ldb a bin; bin-major, two planes of 16 x (8 MAX_J + 4) a warp.
    Row strides against bank conflicts on the mma fragment reads (lda = 4
    mod 8, ldb = 8 mod 16); a bin-minor bin stride of 32 / fc mod 32 more
    spreads the copies along the bins over the banks."""
    qp, pp = pad8(Q), pad8(P)
    lda = qp + 4
    ldb = pp if pp % 16 == 8 else pp + 8
    spread = (32 // fc) % 32 if layout == BIN_MINOR else 0
    xfs = rows * lda + spread
    y = (fc * 2 * (rows * ldb + spread) if layout == BIN_MINOR
         else WARPS * 2 * 16 * (8 * MAX_J + 4))
    return 4 * (fc * (3 * qp * ldb + stages * 2 * xfs) + y)


def _fits(smem: int, per_sm: int) -> bool:
    return smem <= MAX_SMEM and per_sm * (smem + SMEM_RESERVED) <= SM_SMEM


def plan(F: int, N: int, Q: int, P: int, layout: int) -> SpectralPlan:
    """The launch plan of one call, a pure function of the shapes and the
    layout (the choices below are the fastest of a sweep on the H100 at
    the 11 batch-prefill shapes, as rules).

    - Bin-major: two bins a chunk, so a block's planes stay small and the
      X ring gets the shared memory; 64 rows a tile, else 32, else 16,
      two blocks an SM where they fit, else one.
    - Bin-minor: the copies run along the bins, so as many bins a chunk as
      fit two blocks an SM (at least 4), else one block an SM, else fewer;
      16 rows a tile.

    Three X stages where they fit beside, else two.  Column tiles a warp
    unit: two where the chunk's bins, row tiles and column groups still
    give every warp a unit a tile, else one.  Row-tile splits: as many as
    fill the SMs once with the chunks (each block keeps its planes for all
    its tiles), never more than the tiles."""
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"spectral_matmul: unknown layout {layout!r}")
    if min(F, N, Q, P) < 1:
        raise ValueError(f"spectral_matmul: empty shape F={F}, N={N}, "
                         f"Q={Q}, P={P}")
    widest = [fc for fc in FCS if fc < 2 * F]
    nt = pad8(P) // 8
    groups = -(-nt // MAX_J)
    if layout == BIN_MAJOR:
        fc = min(2, widest[0])
        tries = [(per_sm, fc, rows) for per_sm, rows in
                 ((2, 64), (2, 32), (1, 64), (1, 32), (2, 16), (1, 16))]
    else:
        tries = [(per_sm, fc, 16) for per_sm, fmin in ((2, 4), (1, 4), (1, 1))
                 for fc in widest if fc >= fmin]
    for per_sm, fc, rows in tries:
        for stages in (3, 2):
            smem = smem_bytes(Q, P, layout, fc, rows, stages)
            if not _fits(smem, per_sm):
                continue
            chunks = -(-F // fc)
            bins = -(-F // chunks)
            jn = MAX_J if bins * (rows // 16) * groups >= WARPS else 1
            tiles = -(-N // rows)
            splits = max(1, min(tiles, SMS * per_sm // chunks, MAX_GRID_Y))
            return SpectralPlan(layout, chunks, splits, fc, rows, stages,
                                min(jn, nt), smem, per_sm)
    raise ValueError(f"spectral_matmul: no launch plan fits shared memory "
                     f"for Q={Q}, P={P} ({MAX_SMEM} bytes a block)")


def _strided(t: torch.Tensor, strides) -> bool:
    return all(s == e for n, s, e in zip(t.shape, t.stride(), strides)
               if n > 1)


def layout_of(xr, xi, wr, ws1, ws2) -> int:
    """``BIN_MAJOR`` or ``BIN_MINOR`` from the operands' element strides;
    raises ``ValueError`` for any other layout or for shapes that do not
    fit."""
    if xr.dim() != 3 or wr.dim() != 3:
        raise ValueError(f"spectral_matmul: xr {tuple(xr.shape)} and wr "
                         f"{tuple(wr.shape)} must be (F, B, Q) and (F, Q, P)")
    F, B, Q = xr.shape
    P = wr.shape[-1]
    if xi.shape != xr.shape or wr.shape[:2] != (F, Q) or \
            ws1.shape != wr.shape or ws2.shape != wr.shape:
        raise ValueError(f"spectral_matmul: x planes {tuple(xr.shape)} / "
                         f"{tuple(xi.shape)} do not fit w planes "
                         f"{tuple(wr.shape)} / {tuple(ws1.shape)} / "
                         f"{tuple(ws2.shape)}")
    want = {BIN_MAJOR: ((B * Q, Q, 1), (Q * P, P, 1)),
            BIN_MINOR: ((1, Q * F, F), (1, F, Q * F))}
    for layout, (sx, sw) in want.items():
        if all(_strided(t, sx) for t in (xr, xi)) and \
                all(_strided(t, sw) for t in (wr, ws1, ws2)):
            return layout
    raise ValueError(
        f"spectral_matmul: strides x {xr.stride()} / {xi.stride()}, w "
        f"{wr.stride()} / {ws1.stride()} / {ws2.stride()} are neither "
        f"bin-major (x {want[BIN_MAJOR][0]}, w {want[BIN_MAJOR][1]}) nor "
        f"bin-minor (x {want[BIN_MINOR][0]}, w {want[BIN_MINOR][1]})")


def shape_key(F: int, N: int, Q: int, P: int, layout: int) -> str:
    """A launch's shape and layout as ``Kernel.shape_launches`` counts it."""
    return f"{F}x{N}x{Q}x{P}/{LAYOUT_NAMES[layout]}"


def work(F: int, N: int, Q: int, P: int) -> Work:
    """What one launch does, in either layout: 6 operations a bin, row,
    input and output (three real products, a multiply and an add each);
    bytes are the two input planes, the three weight planes and the two
    output planes once each, float32; no scratch."""
    return Work(6.0 * F * N * Q * P,
                4 * F * (2 * N * Q + 3 * Q * P + 2 * N * P), 0)


def launch_work(fn: str, ints: Sequence) -> Work:
    """``work`` of a launch from its integer arguments (F, N, Q, P, the
    layout, the plan): the stand-in's count (``kernels/standin.py``)."""
    return work(*ints[:4])


def _outputs(layout: int, F: int, B: int, P: int, device):
    """(yr, yi), each (F, B, P) in X's layout."""
    if layout == BIN_MAJOR:
        shape, perm = (F, B, P), (0, 1, 2)
    else:
        shape, perm = (B, P, F), (2, 0, 1)
    return tuple(torch.empty(shape, device=device,
                             dtype=torch.float32).permute(*perm)
                 for _ in range(2))


def spectral_matmul_plain(xr, xi, wr, ws1, ws2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the Gauss identity as three batched products over F
    (any strides; contiguous (F, B, P) results)."""
    t1 = torch.bmm(xr + xi, wr)
    t2 = torch.bmm(xr, ws1)
    t3 = torch.bmm(xi, ws2)
    return t1 - t3, t1 + t2


def spectral_matmul(xr, xi, wr, ws1, ws2) -> Tuple[torch.Tensor, torch.Tensor]:
    """xr/xi: (F, B, Q) float32; wr/ws1/ws2: (F, Q, P) float32, all in one
    of the two layouts -> (yr, yi), each (F, B, P) float32 in X's layout."""
    layout = layout_of(xr, xi, wr, ws1, ws2)
    F, B, Q = xr.shape
    P = wr.shape[-1]
    if on_cpu(xr):
        yr, yi = _outputs(layout, F, B, P, xr.device)
        for out, val in zip((yr, yi), spectral_matmul_plain(xr, xi, wr, ws1,
                                                            ws2)):
            out.copy_(val)
        return yr, yi
    f32 = (torch.float32,)
    names = ("xr", "xi", "wr", "ws1", "ws2")
    device = check_cuda("spectral_matmul", dict(zip(names, (xr, xi, wr, ws1,
                                                            ws2))),
                        {n: f32 for n in names}, contiguous=False)
    pl = plan(F, B, Q, P, layout)
    yr, yi = _outputs(layout, F, B, P, device)
    KERNEL.launch("spectral_matmul", device, ptr(xr), ptr(xi), ptr(wr),
                  ptr(ws1), ptr(ws2), ptr(yr), ptr(yi), F, B, Q, P, layout,
                  pl.chunks, pl.fc, pl.rows, pl.stages, pl.jn, pl.splits,
                  shape=shape_key(F, B, Q, P, layout))
    return yr, yi
