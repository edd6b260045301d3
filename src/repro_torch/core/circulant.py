"""Block-circulant linear algebra (port of ``repro/core/circulant.py``).

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

The ``kernel_fn`` hook of ``bc_matmul_spectral`` is ported with ``repro``'s
rule: with it set and float32 planes, the contraction is
``kernel_fn(xr, xi, cache)`` (the port's is ``kernels/ops.py:
spectral_contract``, the ``spectral_matmul`` kernel), while the DFT and
inverse DFT stay dense products against ``dft_mats``; quantized planes skip
it.  ``apply_linear(..., kernel_fn=...)`` routes a hooked projection with
float32 planes there and a hooked projection with quantized planes to the
fused kernel's quantized lane.  ``repro`` leaves the hook unwired; the
port's batch engine passes it at prefill (``serve/engine.py:Engine``).

Quantized planes (``repro_torch.quant``: int8, or packed-int4 ``uint8``,
with ``<name>_s`` per-block-row scales beside them) contract in float32
and fold each plane's scale into its term after the contraction, as
``repro`` does.

Projection fusion (``CompressionConfig.fuse_projections``) is ported for
serving: ``bc_matmul_fused`` runs q/k/v (or up/gate), which share their
input, as one projection against the planes of their generators
concatenated on the output-block axis (``fused_spectral_cache``), so one
input DFT and one fused-kernel launch serve all of them; the output is
split at the projections' offsets, as ``repro`` does.

Training (``mode="train"``) runs the ``fft`` lowering with ``repro``'s
hand-derived backward (``_bc_fft_bwd``, the paper's Eqns. 2-3) as a
``torch.autograd.Function``, ``BCMatmulFFT``: it saves the primals
``(xb, w)``, not their spectra.  The forward derives the planes of ``w``
per call and runs the fused kernel; the backward's input gradient is the
same kernel on the adjoint planes and its weight gradient the
``bc_grad_w`` kernel (``kernels/ops.py``: the plain versions on the CPU).
Baked planes are never read in train mode, so a trained model is re-baked
before it serves (``serve/params.py``).  Fused projections train through
the same Function on their generators concatenated on the output-block
axis; the gradient flows back through ``torch.cat``.  An MoE expert stack
trains through it too, with a leading expert axis (xb (E, C, q, k), w (E,
p, q, k): ``repro``'s ``jax.vmap(bc_matmul_fft)``): on the card its
forward and its input gradient are one fused-kernel launch each for the
whole stack and its weight gradient one ``bc_grad_w`` call.  A ``spectral`` path
in train mode takes the ``fft`` lowering too (the same math, with a
backward).
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


def register_planes(module: nn.Module, prefix: str) -> None:
    """Empty buffers ``<prefix>_<key>`` for a baked cache's planes and
    scales, so that ``.to()`` moves them with the weights once set."""
    for key in CACHE_KEYS:
        module.register_buffer(f"{prefix}_{key}", None)


def planes_of(module: nn.Module, prefix: str
              ) -> Optional[Dict[str, torch.Tensor]]:
    """The cache baked into ``module``'s ``<prefix>_*`` buffers, or None."""
    planes = {key: getattr(module, f"{prefix}_{key}") for key in CACHE_KEYS}
    planes = {key: t for key, t in planes.items() if t is not None}
    return planes or None


def set_planes(module: nn.Module, prefix: str,
               cache: Dict[str, torch.Tensor]) -> None:
    for key, t in cache.items():
        setattr(module, f"{prefix}_{key}", t)


def drop_planes(model: nn.Module) -> None:
    """Forget every baked cache in ``model`` (each module's
    ``plane_caches()``): its planes go stale once the generators change,
    and the next bake derives them anew."""
    for m in model.modules():
        for prefix, cache in getattr(m, "plane_caches", dict)().items():
            set_planes(m, prefix, {key: None for key in cache})


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
    must not modify the returned tensors.  Under a fake-tensor mode (the
    dry run's trace) they are cached on the mode: a fake tensor belongs to
    the mode that made it."""
    fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    if fake is not None:
        mats = fake.__dict__.setdefault("_dft_mats", {})
        key = (k, str(torch.device(device)))
        if key not in mats:
            mats[key] = tuple(torch.as_tensor(m.copy(), device=device)
                              for m in _dft_mats_np(k))
        return mats[key]
    return _dft_mats_on(k, str(torch.device(device)))


def rfft_planes(x: torch.Tensor, k: int):
    """rfft of a real (..., k) array as two real planes (..., kf)."""
    if k <= _DFT_MATMUL_MAX:
        Cr, Ci, _, _ = dft_mats(k, x.device)
        return x @ Cr.to(x.dtype), x @ Ci.to(x.dtype)
    xf = torch.fft.rfft(x, dim=-1)
    return xf.real, xf.imag


def irfft_planes(yr: torch.Tensor, yi: torch.Tensor, k: int):
    """irfft from real planes (..., kf) -> (..., k)."""
    if k <= _DFT_MATMUL_MAX:
        _, _, Dr, Di = dft_mats(k, yr.device)
        return yr @ Dr.to(yr.dtype) + yi @ Di.to(yr.dtype)
    return torch.fft.irfft(torch.complex(yr, yi), n=k, dim=-1)


# ---------------------------------------------------------------------------
# Spectral weight cache (offline FFT of the generators)
# ---------------------------------------------------------------------------
def spectral_cache(w: torch.Tensor, gauss: bool = True) -> Dict[str, torch.Tensor]:
    """rfft(w) as real planes (..., p, q, kf), plus the Gauss combinations
    ``ws1 = wi - wr`` and ``ws2 = wr + wi`` that make the MAC 3 products.
    Leading axes pass through: an MoE's (E, p, q, k) expert stack gives
    (E, p, q, kf) planes.  Float32, as ``repro``'s; float64 generators
    stay float64 (the plain training path's ``gradcheck``)."""
    wr, wi = rfft_planes(w if w.dtype == torch.float64 else w.float(),
                         w.shape[-1])
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


class BCMatmulFFT(torch.autograd.Function):
    """``y (N, p, k) = Σ_j circ(w[:, j]) xb[:, j]`` with the paper's
    backward (``repro``'s ``_bc_fft_core`` and ``_bc_fft_bwd``):

      dL/dxb_j  = Σ_i C_ij^T g_i  : the fused kernel on W^H's planes
      dL/dw_ij  = Σ_n g_i ⋆ x_j   : ``bc_grad_w``

    xb (N, q, k) and w (p, q, k) are float32, or an expert stack's xb (E,
    C, q, k) and w (E, p, q, k) (each expert's rows against its own
    generators); the primals are saved and the spectra recomputed in the
    backward."""

    @staticmethod
    def forward(ctx, xb, w, gauss):
        from ..kernels import ops as kops   # kernels import this module
        ctx.save_for_backward(xb, w)
        ctx.gauss = gauss
        return kops.bc_forward(xb, w, gauss)

    @staticmethod
    def backward(ctx, gy):
        from ..kernels import ops as kops
        xb, w = ctx.saved_tensors
        gy = gy.to(xb.dtype).contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = kops.bc_adjoint(gy, w, ctx.gauss)
        if ctx.needs_input_grad[1]:
            gw = kops.bc_grad_w(gy, xb, w.shape[-1])
        return gx, gw, None


def bc_matmul_fft(x: torch.Tensor, w: torch.Tensor, n_out: int,
                  gauss: bool = True) -> torch.Tensor:
    """Training path: (..., n_in) -> (..., n_out) through ``BCMatmulFFT``;
    an expert stack w (E, p, q, k) takes x (E, C, n_in) -> (E, C, n_out).
    Casts to float32 before blockifying and back to ``x.dtype`` after, as
    ``repro`` does."""
    *experts, p, q, k = w.shape
    lead = x.shape[:-1]
    xb = _blockify(x, q, k).float().reshape(*experts, -1, q, k).contiguous()
    y = BCMatmulFFT.apply(xb, w.float(), gauss)
    return y.reshape(*lead, p * k)[..., :n_out].to(x.dtype)


def bc_matmul_spectral(x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       k: int, n_out: int, gauss: bool = True,
                       kernel_fn=None) -> torch.Tensor:
    """Inference path: cached spectral planes, real-plane Gauss
    contraction.  Casts to float32 before blockifying and back to
    ``x.dtype`` after, as ``repro`` does.

    ``kernel_fn(xr, xi, cache)`` replaces the contraction when the cache is
    not quantized (``repro``'s rule: quantized caches keep the
    scale-folding einsum); without it the contraction is plain PyTorch."""
    p, q, kf = cache["wr"].shape
    dtype = x.dtype
    xb = _blockify(x, q, k).float()
    xr, xi = rfft_planes(xb, k)
    if kernel_fn is not None and "wr_s" not in cache:
        yr, yi = kernel_fn(xr, xi, cache)
    elif gauss and "ws1" in cache:
        yr, yi = _gauss_contract(xr, xi, cache, "...qf,pqf->...pf")
    else:
        yr, yi = _naive_complex_contract(xr, xi, cache, "...qf,pqf->...pf")
    y = irfft_planes(yr, yi, k)
    y = y.reshape(*x.shape[:-1], p * k)[..., :n_out]
    return y.to(dtype)


def fused_spectral_cache(ws, gauss: bool = True) -> Dict[str, torch.Tensor]:
    """Spectral cache of several generators (p_i, q, k) concatenated on the
    output-block axis: (Σp_i, q, kf) planes, in the order of ``ws``, the
    order the fused call splits its output in (q/k/v, up/gate).  The rfft
    acts per block, so this equals the concatenation of each generator's
    ``spectral_cache``."""
    return spectral_cache(torch.cat(list(ws), dim=-3), gauss)


def bc_matmul_fused(x: torch.Tensor, ws, n_outs, mode: str = "serve",
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    gauss: bool = True, kernel_fn=None):
    """Several projections of one input as one: ``x`` (..., n_in) against
    the generators ``ws`` ((p_i, q, k) each) -> a list of (..., n_outs[i]).

    ``cache`` is the baked ``fused_spectral_cache(ws)`` (float32, or int8 /
    packed int4 with per-block-row scales over Σp_i), derived on the fly
    when absent.  The contraction runs as one projection of Σp_i·k outputs
    (``_spectral_linear``: one fused-kernel launch, or the ``kernel_fn``
    hook's MAC for float32 planes), then the output is split at the
    offsets p_i·k, as ``repro`` does.  In train mode the generators are
    concatenated instead and run through ``bc_matmul_fft`` (``cache`` is
    not read)."""
    ps = [w.shape[-3] for w in ws]
    k = ws[0].shape[-1]
    if mode == "train":
        y = bc_matmul_fft(x, torch.cat(list(ws), dim=-3), sum(ps) * k, gauss)
    else:
        if cache is None:
            cache = fused_spectral_cache(ws, gauss)
        y = _spectral_linear(x, cache, k, gauss, sum(ps) * k, kernel_fn)
    outs, off = [], 0
    for p_i, n_out in zip(ps, n_outs):
        outs.append(y[..., off:off + n_out])
        off += p_i * k
    return outs


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


def _spectral_linear(x, cache, k: int, gauss: bool, n_out: int, kernel_fn):
    """One projection against spectral planes: through ``kernel_fn`` when
    the hook is set, the planes are float32 and the hook takes them (a
    hook with a ``takes(cache)`` method decides projection by projection),
    else the fused kernel (its quantized lane for int8 / int4 planes)."""
    from ..kernels import ops as kops   # kernels import this module
    takes = getattr(kernel_fn, "takes", None)
    if kernel_fn is not None and "wr_s" not in cache and (
            takes is None or takes(cache)):
        return bc_matmul_spectral(x, cache, k, n_out, gauss, kernel_fn)
    return kops.bc_linear(x, cache, k, n_out, gauss)


def apply_linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 spec: LinearSpec, n_out: int, mode: str = "serve",
                 kernel_fn=None) -> torch.Tensor:
    """y = x W (+ b).  For block-circulant, W is the (n_out × n_in) generator.

    Outside train mode, baked planes (``params["wc_cache"]``) go straight to
    the fused spectral kernel; so do planes derived on the fly for the
    ``spectral`` path.  With ``kernel_fn`` set, float32 planes go through
    ``bc_matmul_spectral`` with the hook instead (module docstring).  In
    train mode the ``fft`` and ``spectral`` paths run ``bc_matmul_fft``."""
    if spec.kind == "dense":
        y = x @ params["w"].to(x.dtype)
    else:
        path = spec.resolve_path(mode)
        if mode != "train" and "wc_cache" in params:
            y = _spectral_linear(x, params["wc_cache"], spec.block_size,
                                 spec.gauss, n_out, kernel_fn)
        elif path == "direct":
            y = bc_matmul_direct(x, params["wc"], n_out)
        elif path == "spectral" and mode != "train":
            y = _spectral_linear(x, spectral_cache(params["wc"], spec.gauss),
                                 spec.block_size, spec.gauss, n_out,
                                 kernel_fn)
        else:
            y = bc_matmul_fft(x, params["wc"], n_out, gauss=spec.gauss)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def read_planes(cache: Dict[str, torch.Tensor], gauss: bool
                ) -> Dict[str, torch.Tensor]:
    """The planes (and scales) of ``cache`` a contraction reads: wr, ws1,
    ws2 under the Gauss trick where baked, else wr, wi."""
    names = (("wr", "ws1", "ws2") if gauss and "ws1" in cache
             else ("wr", "wi"))
    return {n: t for n, t in cache.items() if n.split("_")[0] in names}


class FusedProjections:
    """Mixin of a module whose projections ``FUSED`` (``Linear`` children)
    share their input, so that projection fusion can run them as one
    (``bc_matmul_fused``).  Their concatenated planes, once baked
    (``bake_fused``), live in the module's ``<FUSED_CACHE>_*`` buffers;
    the projections then keep no planes of their own."""
    FUSED_CACHE: str = ""
    FUSED: Tuple[str, ...] = ()
    may_fuse: bool = True         # False: never fused (cross-attention)

    def fused_linears(self):
        return [getattr(self, n) for n in self.FUSED]

    @property
    def fused_cache(self) -> Optional[Dict[str, torch.Tensor]]:
        return planes_of(self, self.FUSED_CACHE)

    def plane_caches(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Baked caches by buffer prefix (``quant/codec.py:baked_caches``)."""
        cache = self.fused_cache
        return {} if cache is None else {self.FUSED_CACHE: cache}

    def bake_fused(self, gauss: bool = True) -> None:
        """Store ``fused_spectral_cache`` of the projections (idempotent)."""
        if self.fused_cache is None:
            with torch.no_grad():
                set_planes(self, self.FUSED_CACHE, fused_spectral_cache(
                    [m.wc for m in self.fused_linears()], gauss))

    def fused(self, x: torch.Tensor, mode: str = "serve", kernel_fn=None):
        """The projections of ``x`` as one call (``bc_matmul_fused``), each
        output without its bias."""
        lins = self.fused_linears()
        cache = self.fused_cache if mode != "train" else None
        return bc_matmul_fused(x, [m.wc for m in lins],
                               [m.n_out for m in lins], mode, cache=cache,
                               gauss=lins[0].spec.gauss, kernel_fn=kernel_fn)


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
        register_planes(self, "wc_cache")

    @property
    def wc_cache(self) -> Optional[Dict[str, torch.Tensor]]:
        return planes_of(self, "wc_cache")

    def plane_caches(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Baked caches by buffer prefix (``quant/codec.py:baked_caches``)."""
        cache = self.wc_cache
        return {} if cache is None else {"wc_cache": cache}

    def bake_spectral(self, gauss: bool = True) -> None:
        """Store ``spectral_cache(wc)`` next to the generators (idempotent)."""
        if self.wc_cache is None:
            with torch.no_grad():
                set_planes(self, "wc_cache", spectral_cache(self.wc, gauss))

    def params(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name in ("w", "wc", "b"):
            if hasattr(self, name):
                out[name] = getattr(self, name)
        cache = self.wc_cache
        if cache is not None:
            out["wc_cache"] = cache
        return out

    def forward(self, x: torch.Tensor, mode: str = "serve",
                kernel_fn=None) -> torch.Tensor:
        return apply_linear(self.params(), x, self.spec, self.n_out, mode,
                            kernel_fn)



# ---------------------------------------------------------------------------
# Accounting (``core/compression.py``; ``repro``'s formulas)
# ---------------------------------------------------------------------------
def dense_flops(batch: int, n_in: int, n_out: int) -> int:
    return 2 * batch * n_in * n_out


def bc_flops(batch: int, n_in: int, n_out: int, k: int,
             gauss: bool = True) -> int:
    """FLOPs of the decoupled spectral pipeline (the paper's complexity
    analysis): rfft + irfft at a split-radix estimate, plus the complex
    MACs as real operations."""
    p, q, kf = num_blocks(n_out, k), num_blocks(n_in, k), k // 2 + 1
    fft = int(2.5 * batch * (q + p) * k * max(math.log2(k), 1))
    muls = 3 if gauss else 4
    mac = 2 * muls * batch * p * q * kf
    return fft + mac


def dense_param_bytes(n_in: int, n_out: int, bytes_per: int = 2) -> int:
    return n_in * n_out * bytes_per


def bc_param_bytes(n_in: int, n_out: int, k: int, bytes_per: int = 4,
                   spectral: bool = False) -> int:
    """Bytes of the generators, or with ``spectral`` of the cached rfft
    planes (2 * kf reals a block)."""
    p, q = num_blocks(n_out, k), num_blocks(n_in, k)
    if spectral:
        return p * q * (k // 2 + 1) * 2 * bytes_per
    return p * q * k * bytes_per
