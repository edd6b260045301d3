"""Block-circulant linear algebra, serve half (port of ``repro/core/circulant.py``).

A weight ``W ∈ R^{m×n}`` is held as generators ``w ∈ R^{p×q×k}``
(``p = m/k``, ``q = n/k``); block ``(i, j)`` of ``W`` is the circulant matrix
``C[r, c] = w[i, j, (r - c) mod k]``, so ``y_i = Σ_j irfft(rfft(w_ij) ∘ rfft(x_j))``.

Serving runs the ``spectral`` lowering: the generators are FFT'd once,
offline (``spectral_cache``, baked by ``serve/params.py``), and each call
does input DFT → Gauss 3-multiply MAC against the cached planes → inverse
DFT.  The DFTs are dense products against the same float64-built,
float32-cast DFT matrices ``repro`` uses (``dft_mats``).

``apply_linear`` sends that pipeline through the fused kernel
(``kernels/bc_fused.py``; CUDA on the card, its plain version on the CPU).
That is a deliberate difference from ``repro``, whose serve path leaves the
Pallas kernel unwired and runs ``bc_matmul_spectral`` through XLA;
``bc_matmul_spectral`` here is the same plain math and the reference the
kernel is held against.

Quantized planes (``repro_torch.quant``: int8, or packed-int4 ``uint8``,
with ``<name>_s`` per-block-row scales beside them) contract in float32
and fold each plane's scale into its term after the contraction, as
``repro`` does.

Not ported yet (they raise ``NotImplementedError``): the training path
(``bc_matmul_fft`` and its hand-derived backward) and ``bc_matmul_fused``
(projection fusion).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..quant.codec import plane_from_cache

_DFT_MATMUL_MAX = 512     # above this block size the DFT runs as torch.fft
PLANES = ("wr", "wi", "ws1", "ws2")
# buffer keys of a baked cache: the planes, then their quantization scales
CACHE_KEYS = PLANES + tuple(f"{n}_s" for n in PLANES)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def num_blocks(dim: int, k: int) -> int:
    """Number of circulant blocks covering ``dim`` (zero-pad if k ∤ dim)."""
    return -(-dim // k)


def init_block_circulant(n_in: int, n_out: int, k: int, *,
                         generator: torch.Generator,
                         device: torch.device,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Generators ``w (p, q, k)`` for an (n_out × n_in) weight, with the
    variance of a dense ``1/sqrt(n_in)`` init."""
    p, q = num_blocks(n_out, k), num_blocks(n_in, k)
    scale = scale if scale is not None else 1.0 / math.sqrt(max(n_in, 1))
    return torch.randn((p, q, k), generator=generator, device=device,
                       dtype=torch.float32) * scale


def materialize_dense(w: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Expand generators (p, q, k) into the dense (m, n) block-circulant W."""
    p, q, k = w.shape
    r = torch.arange(k, device=w.device)
    idx = (r[:, None] - r[None, :]) % k            # C[r,c] = w[(r-c) mod k]
    blocks = w[:, :, idx]                          # (p, q, k, k)
    dense = blocks.permute(0, 2, 1, 3).reshape(p * k, q * k)
    return dense[:m, :n]


# ---------------------------------------------------------------------------
# DFT as dense products
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def _dft_mats_np(k: int) -> Tuple[np.ndarray, ...]:
    n = np.arange(k)[:, None]
    f = np.arange(k // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * f / k
    Cr = np.cos(ang)                                   # (k, kf)
    Ci = -np.sin(ang)
    # irfft weights: bin 0 (and k/2 when k even) count once, others twice
    wgt = np.full((k // 2 + 1,), 2.0 / k)
    wgt[0] = 1.0 / k
    if k % 2 == 0:
        wgt[-1] = 1.0 / k
    Dr = (Cr * wgt[None, :]).T                         # (kf, k)
    Di = (Ci * wgt[None, :]).T                         # y = Xr@Dr + Xi@Di
    return tuple(m.astype(np.float32) for m in (Cr, Ci, Dr, Di))


@functools.lru_cache(maxsize=32)
def _dft_mats_on(k: int, device: str) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(m.copy()).to(device)
                 for m in _dft_mats_np(k))


def dft_mats(k: int, device="cpu") -> Tuple[torch.Tensor, ...]:
    """Real rfft/irfft as matrices ``(Cr, Ci, Dr, Di)``: ``X = x@C`` (two
    planes), ``x = Xr@Dr + Xi@Di``.  Built in float64 with numpy and cast to
    float32, exactly as ``repro`` builds them; cached per device, so callers
    must not modify the returned tensors."""
    return _dft_mats_on(k, str(torch.device(device)))


def rfft_planes(x: torch.Tensor, k: int):
    """rfft of a real (..., k) array as two real planes (..., kf)."""
    if k <= _DFT_MATMUL_MAX:
        Cr, Ci, _, _ = dft_mats(k, x.device)
        return x @ Cr, x @ Ci
    xf = torch.fft.rfft(x, dim=-1)
    return xf.real, xf.imag


def irfft_planes(yr: torch.Tensor, yi: torch.Tensor, k: int):
    """irfft from real planes (..., kf) -> (..., k)."""
    if k <= _DFT_MATMUL_MAX:
        _, _, Dr, Di = dft_mats(k, yr.device)
        return yr @ Dr + yi @ Di
    return torch.fft.irfft(torch.complex(yr, yi), n=k, dim=-1)


# ---------------------------------------------------------------------------
# Spectral weight cache (offline FFT of the generators)
# ---------------------------------------------------------------------------
def spectral_cache(w: torch.Tensor, gauss: bool = True) -> Dict[str, torch.Tensor]:
    """rfft(w) as real planes (p, q, kf), plus the Gauss combinations
    ``ws1 = wi - wr`` and ``ws2 = wr + wi`` that make the MAC 3 products."""
    wr, wi = rfft_planes(w.float(), w.shape[-1])
    out = {"wr": wr, "wi": wi}
    if gauss:
        out["ws1"] = wi - wr
        out["ws2"] = wr + wi
    return out


def _fold(t, scale):
    """Fold a quantized plane's (p, 1) row scale into its (..., p, kf)
    term once, after the contraction (``repro``'s ``_fold``)."""
    return t if scale is None else t * scale


def _gauss_contract(xr, xi, cache, contract: str):
    """Complex contraction ``Y = X · W`` with Gauss's 3 real products:
    re = t1 - t3, im = t1 + t2 with t1 = (xr+xi)·wr, t2 = xr·ws1,
    t3 = xi·ws2.  Quantized caches fold each plane's scale into its term
    (the identity is linear in each plane)."""
    kf = xr.shape[-1]
    wr, s1 = plane_from_cache(cache, "wr", kf)
    ws1, s2 = plane_from_cache(cache, "ws1", kf)
    ws2, s3 = plane_from_cache(cache, "ws2", kf)
    t1 = _fold(torch.einsum(contract, xr + xi, wr), s1)
    t2 = _fold(torch.einsum(contract, xr, ws1), s2)
    t3 = _fold(torch.einsum(contract, xi, ws2), s3)
    return t1 - t3, t1 + t2


def _naive_complex_contract(xr, xi, cache, contract: str):
    """4-product complex contraction (used when the Gauss planes are absent)."""
    kf = xr.shape[-1]
    wr, sr = plane_from_cache(cache, "wr", kf)
    wi, si = plane_from_cache(cache, "wi", kf)
    yr = (_fold(torch.einsum(contract, xr, wr), sr)
          - _fold(torch.einsum(contract, xi, wi), si))
    yi = (_fold(torch.einsum(contract, xr, wi), si)
          + _fold(torch.einsum(contract, xi, wr), sr))
    return yr, yi


# ---------------------------------------------------------------------------
# Lowerings
# ---------------------------------------------------------------------------
def _blockify(x: torch.Tensor, q: int, k: int) -> torch.Tensor:
    """(..., n) -> (..., q, k) with zero padding up to q*k."""
    n = x.shape[-1]
    if n < q * k:
        x = F.pad(x, (0, q * k - n))
    return x.reshape(*x.shape[:-1], q, k)


def bc_matmul_direct(x: torch.Tensor, w: torch.Tensor, n_out: int) -> torch.Tensor:
    """Oracle: y = W x via the materialized dense W.  (..., n) -> (..., n_out)."""
    p, q, k = w.shape
    dense = materialize_dense(w, p * k, q * k)
    xp = _blockify(x, q, k).reshape(*x.shape[:-1], q * k)
    y = torch.einsum("...n,mn->...m", xp, dense.to(x.dtype))
    return y[..., :n_out]


def bc_matmul_fft(*args, **kwargs):
    raise NotImplementedError("the training path (bc_matmul_fft and its "
                              "hand-derived backward) is not ported yet")


def bc_matmul_fused(*args, **kwargs):
    raise NotImplementedError("projection fusion (bc_matmul_fused) is not "
                              "ported yet")


def bc_matmul_spectral(x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       k: int, n_out: int, gauss: bool = True) -> torch.Tensor:
    """Inference path in plain PyTorch: cached spectral planes, real-plane
    Gauss contraction.  Casts to float32 before blockifying and back to
    ``x.dtype`` after, as ``repro`` does."""
    p, q, kf = cache["wr"].shape
    dtype = x.dtype
    xb = _blockify(x, q, k).float()
    xr, xi = rfft_planes(xb, k)
    if gauss and "ws1" in cache:
        yr, yi = _gauss_contract(xr, xi, cache, "...qf,pqf->...pf")
    else:
        yr, yi = _naive_complex_contract(xr, xi, cache, "...qf,pqf->...pf")
    y = irfft_planes(yr, yi, k)
    y = y.reshape(*x.shape[:-1], p * k)[..., :n_out]
    return y.to(dtype)


# ---------------------------------------------------------------------------
# LinearSpec dispatch: every projection goes through here
# ---------------------------------------------------------------------------
class LinearSpec:
    """How one projection is parameterized and lowered."""

    __slots__ = ("kind", "block_size", "path", "gauss", "bias")

    def __init__(self, kind: str = "dense", block_size: int = 0,
                 path: str = "auto", gauss: bool = True, bias: bool = False):
        if kind not in ("dense", "block_circulant"):
            raise ValueError(f"linear kind {kind!r}")
        self.kind = kind
        self.block_size = block_size
        self.path = path
        self.gauss = gauss
        self.bias = bias

    @staticmethod
    def from_config(comp, layer_class: str, bias: bool = False) -> "LinearSpec":
        k = comp.block_for(layer_class) if comp is not None else 0
        if k and comp.enabled:
            return LinearSpec("block_circulant", k, comp.path, comp.gauss_trick, bias)
        return LinearSpec("dense", 0, "auto", True, bias)

    def resolve_path(self, mode: str) -> str:
        if self.path != "auto":
            return self.path
        if self.block_size <= 8:
            return "direct"
        return "fft" if mode == "train" else "spectral"


def apply_linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 spec: LinearSpec, n_out: int, mode: str = "serve") -> torch.Tensor:
    """y = x W (+ b).  For block-circulant, W is the (n_out × n_in) generator.

    Outside train mode, baked planes (``params["wc_cache"]``) go straight to
    the fused spectral kernel; so do planes derived on the fly for the
    ``spectral`` path."""
    from ..kernels import ops as kops   # kernels import this module
    if spec.kind == "dense":
        y = x @ params["w"].to(x.dtype)
    else:
        path = spec.resolve_path(mode)
        if mode != "train" and "wc_cache" in params:
            y = kops.bc_linear(x, params["wc_cache"], spec.block_size, n_out,
                               spec.gauss)
        elif path == "direct":
            y = bc_matmul_direct(x, params["wc"], n_out)
        elif path == "spectral":
            y = kops.bc_linear(x, spectral_cache(params["wc"], spec.gauss),
                               spec.block_size, n_out, spec.gauss)
        else:
            y = bc_matmul_fft(x, params["wc"], n_out, gauss=spec.gauss)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


class Linear(nn.Module):
    """One projection: dense ``w (n_in, n_out)`` or block-circulant
    generators ``wc (p, q, k)``, an optional bias ``b``, and, once
    ``bake_spectral`` has run, the spectral planes as buffers
    (``wc_cache_wr`` ...), so that ``.to()`` moves them with the weights.
    Quantized planes (``quant/codec.py:quantize_serving_params``) keep
    their per-block-row scales in ``wc_cache_wr_s`` ... beside them.

    With a ``generator`` the weights are drawn like ``repro``'s
    ``init_linear`` (same shapes and scales, not the same bits); without
    one they are zeros, to be filled by ``models/convert.py``."""

    def __init__(self, n_in: int, n_out: int, spec: LinearSpec, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_in, self.n_out, self.spec = n_in, n_out, spec
        if spec.kind == "dense":
            scale = 1.0 / math.sqrt(max(n_in, 1))
            w = (torch.randn((n_in, n_out), generator=generator, device=device)
                 * scale if generator is not None
                 else torch.zeros((n_in, n_out), device=device))
            self.w = nn.Parameter(w, requires_grad=False)
        else:
            k = spec.block_size
            self.wc = nn.Parameter(
                init_block_circulant(n_in, n_out, k, generator=generator,
                                     device=device)
                if generator is not None else
                torch.zeros((num_blocks(n_out, k), num_blocks(n_in, k), k),
                            device=device),
                requires_grad=False)
        if spec.bias:
            self.b = nn.Parameter(torch.zeros((n_out,), device=device),
                                  requires_grad=False)
        for name in CACHE_KEYS:
            self.register_buffer(f"wc_cache_{name}", None)

    @property
    def wc_cache(self) -> Optional[Dict[str, torch.Tensor]]:
        planes = {n: getattr(self, f"wc_cache_{n}") for n in CACHE_KEYS}
        planes = {n: t for n, t in planes.items() if t is not None}
        return planes or None

    def bake_spectral(self, gauss: bool = True) -> None:
        """Store ``spectral_cache(wc)`` next to the generators (idempotent)."""
        if self.wc_cache is None:
            for name, plane in spectral_cache(self.wc, gauss).items():
                setattr(self, f"wc_cache_{name}", plane)

    def params(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name in ("w", "wc", "b"):
            if hasattr(self, name):
                out[name] = getattr(self, name)
        cache = self.wc_cache
        if cache is not None:
            out["wc_cache"] = cache
        return out

    def forward(self, x: torch.Tensor, mode: str = "serve") -> torch.Tensor:
        return apply_linear(self.params(), x, self.spec, self.n_out, mode)

