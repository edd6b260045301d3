"""The kernels' entry points for the layers, dispatched by device.

``repro/kernels/ops.py`` chooses a lowering with ``REPRO_KERNELS``; the port
chooses by the tensor it is given.  A CPU tensor takes the plain PyTorch
version, a CUDA tensor takes the hand-written kernel or raises: there is no
switch, no fallback and no ``torch.compile``.

A cache of fused projections (``qkv_cache``, ``upgate_cache``: the planes
of q/k/v or up/gate concatenated on the output-block axis) is one more
(p, q, kf) cache to ``bc_linear`` and ``spectral_contract``: both read it
as it stands, with no copy of its planes.

Without the Gauss trick (``gauss_trick=False``: planes wr, wi without
ws1, ws2, or a caller that asks for the 4-product MAC) every entry point
below takes the fused kernel's 4-product lane (``bc_fused4_matmul``)
instead, on the same terms: its plain version on the CPU, the kernel or
an error on the card.

Training (``core/circulant.py:BCMatmulFFT``, the paper's backward):
``bc_forward`` is the forward of a block-circulant projection from its
generators (planes derived per call), ``bc_adjoint`` its input gradient
(the same fused kernel on the adjoint planes) and ``bc_grad_w`` its weight
gradient (``kernels/bc_grad_w.py``).  Each takes one projection (xb (N,
q, k), w (p, q, k)) or an MoE expert stack (xb (E, C, q, k), w (E, p, q,
k)): ``bc_forward`` on a stack is ``bc_expert_linear``'s training twin,
planes made from ``w`` per call, and on the card each of the three is one
call for the whole stack (one ``bc_fused`` launch, one ``bc_grad_w``
call).  Their CPU versions are the plain ones, expert by expert; on the
card they launch the kernels or raise.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import circulant as cc
from .bc_fused import bc_fused4_matmul, bc_fused_matmul
from .bc_grad_w import bc_grad_w
from .flash_attention import flash_attention
from .paged import paged_gather
from .paged_attention import paged_attention
from .spectral_matmul import spectral_matmul

__all__ = ["bc_adjoint", "bc_expert_linear", "bc_forward", "bc_grad_w",
           "bc_linear", "flash_attention",
           "paged_attention", "paged_gather", "spectral_contract",
           "spectral_matmul"]


def _fused(xb: torch.Tensor, cache: Dict[str, torch.Tensor], k: int,
           gauss: bool) -> torch.Tensor:
    """xb (N, q, k) or a stack (E, C, q, k) float32 through the fused
    kernel: its Gauss lanes where ``gauss`` and the cache has ws1, ws2,
    else its 4-product lanes on wr, wi; a quantized cache (int8 or
    packed-int4 planes with ``<name>_s`` scales) on its integer planes."""
    names = (("wr", "ws1", "ws2") if gauss and "ws1" in cache
             else ("wr", "wi"))
    scales = (tuple(cache[f"{n}_s"] for n in names) if "wr_s" in cache
              else None)
    fn = bc_fused_matmul if len(names) == 3 else bc_fused4_matmul
    return fn(xb, *(cache[n] for n in names), k, scales)


def bc_linear(x: torch.Tensor, cache: Dict[str, torch.Tensor], k: int,
              n_out: int, gauss: bool = True) -> torch.Tensor:
    """Block-circulant linear against baked spectral planes:
    (..., n_in) -> (..., n_out), through the fused kernel (its 4-product
    lane without the Gauss planes or ``gauss``).  Casts to float32 before
    blockifying and back to ``x.dtype`` after, as ``repro``'s
    ``bc_matmul_spectral`` does.  A quantized cache (int8 or packed-int4
    planes with ``<name>_s`` scales) runs the kernel's quantized lane on
    its integer planes."""
    p, q, _ = cache["wr"].shape
    lead = x.shape[:-1]
    xb = cc._blockify(x, q, k).reshape(-1, q, k).float().contiguous()
    y = _fused(xb, cache, k, gauss)
    return y.reshape(*lead, p * k)[..., :n_out].to(x.dtype)


def bc_expert_linear(x: torch.Tensor, cache: Dict[str, torch.Tensor], k: int,
                     n_out: int, gauss: bool = True) -> torch.Tensor:
    """An expert stack's projection: x (E, C, n_in) -> (E, C, n_out),
    expert ``e``'s rows against its planes ``cache[name][e]`` (planes
    (E, p, q, kf), scales (E, p, 1)), as ``repro`` vmaps
    ``bc_matmul_spectral`` over the experts.  The planes go to the fused
    kernel as one stack (Gauss or 4-product, as ``bc_linear`` chooses):
    on the card one launch of its float32, int8 or int4 lane for all E
    experts (each expert's rows at e * C, its planes and scales at their
    strides: nothing is copied), on the CPU its plain version expert by
    expert.  Casts as ``bc_linear`` does."""
    _, p, q, _ = cache["wr"].shape
    E, C, _ = x.shape
    xb = cc._blockify(x, q, k).float().contiguous()       # (E, C, q, k)
    y = _fused(xb, cache, k, gauss)
    return y.reshape(E, C, p * k)[..., :n_out].to(x.dtype)


def spectral_contract(xr: torch.Tensor, xi: torch.Tensor,
                      cache: Dict[str, torch.Tensor]):
    """The ``kernel_fn`` of ``core/circulant.py:bc_matmul_spectral``: the
    Gauss contraction of input spectra ``xr``/``xi`` (..., q, kf) against
    the cache's float32 planes (p, q, kf), through ``spectral_matmul``.

    A function of views: the spectra reach the kernel as (kf, N, q) views
    of their (N, q, kf) storage and the planes as (kf, q, p) views of
    theirs (``spectral_matmul``'s bin-minor layout), and its (kf, N, p)
    result is a view of a contiguous (N, p, kf) buffer, returned as
    (..., p, kf) without a copy.  Spectra whose (N, q, kf) rows are not
    contiguous raise in ``spectral_matmul``; they are never copied."""
    missing = [n for n in ("wr", "ws1", "ws2") if n not in cache]
    if missing:
        raise ValueError(f"spectral_contract needs the Gauss planes; the "
                         f"cache lacks {missing}")
    p, q, kf = cache["wr"].shape
    lead = xr.shape[:-2]
    xs = [t.view(-1, q, kf).permute(2, 0, 1) for t in (xr, xi)]
    ws = [cache[n].permute(2, 1, 0) for n in ("wr", "ws1", "ws2")]
    yr, yi = spectral_matmul(*xs, *ws)
    return tuple(t.permute(1, 2, 0).view(*lead, p, kf) for t in (yr, yi))


def adjoint_planes(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The planes of W^H from W's (p, q, kf): conj(W) has planes (wr, -wi),
    so ``wr' = wr^T`` and the Gauss planes ``ws1' = (-wi - wr)^T =
    -ws2^T``, ``ws2' = (wr - wi)^T = -ws1^T`` (or, without them, ``wi' =
    -wi^T``), each (q, p, kf) and contiguous (a copy of p q kf floats a
    plane).  An expert stack's (E, p, q, kf) planes give (E, q, p, kf):
    the block axes are transposed, not the expert axis.  Contracting with
    them equals ``repro``'s ``_cplx_contract(gr, gi, wr, -wi, ...)`` term
    by term."""
    t = lambda a: a.transpose(-3, -2).contiguous()  # noqa: E731
    if "ws1" in cache:
        return {"wr": t(cache["wr"]), "ws1": t(-cache["ws2"]),
                "ws2": t(-cache["ws1"])}
    return {"wr": t(cache["wr"]), "wi": t(-cache["wi"])}


def _contract(xb: torch.Tensor, cache: Dict[str, torch.Tensor], k: int,
              gauss: bool) -> torch.Tensor:
    """xb (N, q, k) against a float32 cache (p, q, kf) -> (N, p, k), or an
    expert stack xb (E, C, q, k) against (E, p, q, kf) -> (E, C, p, k):
    the fused kernel on the Gauss planes, or its 4-product lane where
    ``gauss`` is off (``repro``'s ``_cplx_contract``); one launch for a
    stack, the plain versions on the CPU."""
    return _fused(xb.contiguous(), cache, k, gauss)


def bc_forward(xb: torch.Tensor, w: torch.Tensor, gauss: bool = True
               ) -> torch.Tensor:
    """y (N, p, k) of xb (N, q, k) float32 against generators w (p, q, k),
    or of an expert stack xb (E, C, q, k) against w (E, p, q, k) -> (E, C,
    p, k): ``spectral_cache(w)`` per call, then the fused kernel."""
    with torch.no_grad():
        cache = cc.spectral_cache(w, gauss)
    return _contract(xb, cache, w.shape[-1], gauss)


def bc_adjoint(gy: torch.Tensor, w: torch.Tensor, gauss: bool = True
               ) -> torch.Tensor:
    """The input gradient gx (N, q, k) of gy (N, p, k): W^H gy, the fused
    kernel on ``adjoint_planes`` (``repro``'s ``_bc_fft_bwd`` gx); an
    expert stack's gy (E, C, p, k) gives (E, C, q, k)."""
    with torch.no_grad():
        cache = adjoint_planes(cc.spectral_cache(w, gauss))
    return _contract(gy, cache, w.shape[-1], gauss)
