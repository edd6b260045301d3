"""Block-circulant CONV layers (the paper's §Inference and Training for
CONV Layers; port of ``repro/core/conv.py``).

If every slice F(·, ·, c, p) of the rank-4 CONV weight F(r, r, C, P) is
block-circulant, the im2col-reshaped matrix F ∈ R^{Cr²×P} is
block-circulant too, and Y = X·F runs through the same FFT pipeline as an
FC layer: im2col, then the block-circulant linear.

Inputs stay NHWC, as in ``repro``.  ``im2col`` gives ``repro``'s feature
order: ``F.unfold``, like XLA's patch op, yields channel-major (C·r·r)
features, which are reordered to (r·r·C) so that the circulant blocks fall
where F(Cr², P) puts them (another order is still a valid convolution, but
not ``repro``'s).  On the card the ``"fft"`` path runs
``circulant.BCMatmulFFT``: the ``bc_fused`` kernel forward and for the
input gradient, ``bc_grad_w`` for the weight gradient; the kernels take
block sizes that are multiples of 8 up to 128 and raise on others
(``kernels/bc_fused.py:plan``).  ``conv2d_dense`` is ``F.conv2d``, the
reference the tests hold the circulant layer against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import circulant as cc


def _pads(H: int, W: int, r: int, stride: int, padding: str):
    """(top, bottom, left, right) zero padding of XLA's ``padding``."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: expected 'SAME' or 'VALID'")
    out = []
    for n in (H, W):
        total = max((-(-n // stride) - 1) * stride + r - n, 0)
        out += [total // 2, total - total // 2]
    return tuple(out)


def im2col(x: torch.Tensor, r: int, stride: int = 1,
           padding: str = "VALID") -> torch.Tensor:
    """x: (B, H, W, C) -> patches (B, Ho, Wo, r*r*C), feature order
    (kernel row, kernel column, channel)."""
    B, H, W, C = x.shape
    top, bottom, left, right = _pads(H, W, r, stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    Ho = (H + top + bottom - r) // stride + 1
    Wo = (W + left + right - r) // stride + 1
    cols = F.unfold(xc, r, stride=stride)            # (B, C*r*r, Ho*Wo)
    cols = cols.reshape(B, C, r * r, Ho, Wo).permute(0, 3, 4, 2, 1)
    return cols.reshape(B, Ho, Wo, r * r * C)


def init_conv_circulant(r: int, c_in: int, c_out: int, k: int, *,
                        generator: torch.Generator,
                        device) -> torch.Tensor:
    """Generators of the im2col'd (r²·C_in × C_out) weight."""
    return cc.init_block_circulant(r * r * c_in, c_out, k,
                                   generator=generator, device=device)


def conv2d_block_circulant(x: torch.Tensor, w: torch.Tensor, r: int,
                           c_out: int, stride: int = 1,
                           padding: str = "VALID",
                           path: str = "fft") -> torch.Tensor:
    """Block-circulant 2-D convolution via im2col.  x: (B, H, W, C) ->
    (B, Ho, Wo, P).  ``path`` "fft" (the training lowering, with its
    backward) or "direct" (the materialized dense W, the oracle)."""
    fn = {"fft": cc.bc_matmul_fft, "direct": cc.bc_matmul_direct}[path]
    return fn(im2col(x, r, stride, padding), w, c_out)


def conv2d_dense(x: torch.Tensor, f: torch.Tensor, stride: int = 1,
                 padding: str = "VALID") -> torch.Tensor:
    """Reference dense convolution.  x: (B, H, W, C), f: (r, r, C_in,
    C_out) -> (B, Ho, Wo, C_out)."""
    r = f.shape[0]
    B, H, W, _ = x.shape
    top, bottom, left, right = _pads(H, W, r, stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xc, f.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)
