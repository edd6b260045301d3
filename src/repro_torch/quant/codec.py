"""Fixed-point inference codec: symmetric absmax int8 (and packed-int4)
quantization of the two serving-state tensors the paper's hardware keeps in
reduced precision (port of ``repro/quant/codec.py``).

* **Spectral weight planes**: the baked ``wr/wi/ws1/ws2`` planes of every
  ``Linear`` are quantized per BLOCK ROW (one scale per output block ``p``),
  so the serve contraction reads int8 planes and folds the float32 scale
  into the output once per row: ``y[..., p, f] = s[p] * (x . q[p])``.
* **Paged KV pool**: the ``(num_pages, page_size, Hkv, D)`` pool stores int8
  with one scale per (page, kv head).  The page scale is a RUNNING absmax:
  when a new token outgrows it, the page's resident codes are requantized to
  the grown scale (``page_scatter``).

Convention (symmetric absmax):

    scale = absmax / Q           (Q = 127 for int8, 7 for int4)
    q     = clip(round(x / scale), -Q, Q)       round half to even
    dq    = q * scale            with  |x - dq| <= scale / 2

A scale of exactly 0 encodes an all-zero block.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the codes equal ``repro``'s bit for bit.

Unlike ``repro``'s pure functions, ``quantize_serving_params`` and
``page_scatter`` write their results IN PLACE (module buffers, pool pages).
This module imports nothing else of the package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

INT8_QMAX = 127.0
INT4_QMAX = 7.0
_EPS = 1e-30

# Plane names a spectral serving cache may carry and the suffix of their
# per-block-row scales (``wr_s`` lives next to ``wr``).
PLANE_NAMES = ("wr", "wi", "ws1", "ws2")
SCALE_SUFFIX = "_s"


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What the serving stack quantizes, threaded through the engine.

    ``kv_dtype`` is the pool's storage dtype ("f32" | "bf16" | "int8");
    ``quant_weights`` switches the baked spectral planes to int8 (or packed
    int4 with ``weight_bits=4``: two nibbles per byte)."""
    kv_dtype: str = "f32"
    quant_weights: bool = False
    weight_bits: int = 8

    def __post_init__(self):
        if self.kv_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: "
                             f"expected 'f32', 'bf16' or 'int8'")
        if self.weight_bits not in (8, 4):
            raise ValueError(f"weight_bits {self.weight_bits}: "
                             f"expected 8 or 4")

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def pool_dtype(self) -> torch.dtype:
        return {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}[self.kv_dtype]

    def describe(self) -> Dict:
        """JSON-able form for ``ContinuousEngine.stats()``."""
        return {"kv_dtype": self.kv_dtype,
                "quant_weights": bool(self.quant_weights),
                "weight_bits": int(self.weight_bits)}


# ---------------------------------------------------------------------------
# Scalar codec
# ---------------------------------------------------------------------------
def absmax_scale(x: torch.Tensor, axes, qmax: float = INT8_QMAX
                 ) -> torch.Tensor:
    """Symmetric absmax scale over ``axes`` (reduced away).  The divisor
    is a tensor beside the absmax: on the card a division by a host
    scalar is a product with its reciprocal, one ulp off the true
    quotient (``repro``'s and the CPU's) at some values."""
    amax = x.float().abs().amax(dim=axes)
    return amax / torch.full_like(amax, qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor,
             qmax: float = INT8_QMAX) -> torch.Tensor:
    """clip(round(x / scale)) as int8; ``scale`` broadcasts against ``x``
    and a zero scale quantizes to 0."""
    q = torch.round(x.float() / torch.clamp(scale, min=_EPS))
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def saturation_counts(q: torch.Tensor, qmax: float = INT8_QMAX
                      ) -> Tuple[torch.Tensor, int]:
    """``(clipped, total)``: entries AT the ±qmax rail (a float32 tensor
    scalar) out of ``q.numel()``.  With absmax scaling nothing lands outside
    the rail, so this is a saturation census, not an overflow count."""
    sat = q.float().abs() >= float(qmax)
    return sat.sum().float(), int(q.numel())


# ---------------------------------------------------------------------------
# int4 nibble packing
# ---------------------------------------------------------------------------
def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-7, 7] two per byte along the last axis (low
    nibble first); an odd length is zero-padded.  Returns uint8, the dtype
    that marks int4 planes downstream."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo = q[..., 0::2].to(torch.uint8) & 0xF           # two's-complement nibble
    hi = q[..., 1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: (..., ceil(n/2)) uint8 -> (..., n) int8."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = (lo ^ 8) - 8                                 # sign-extend the nibble
    hi = (hi ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                2 * packed.shape[-1])
    return out[..., :n]


# ---------------------------------------------------------------------------
# Spectral weight planes: per-block-row quantization
# ---------------------------------------------------------------------------
def quantize_plane(w: torch.Tensor, bits: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (..., p, q, kf) plane -> (int8 plane, or packed uint8 for
    ``bits=4``; (..., p, 1) float32 scale).  The scale reduces over the
    input-block and frequency axes: one value per output block row."""
    qmax = INT8_QMAX if bits == 8 else INT4_QMAX
    scale = absmax_scale(w, axes=(-2, -1), qmax=qmax)[..., None]
    q = quantize(w, scale[..., None], qmax)
    if bits == 4:
        q = pack_int4(q)
    return q, scale.float()


def quantize_plane_cache(cache: Dict[str, torch.Tensor],
                         bits: int = 8) -> Dict[str, torch.Tensor]:
    """Quantize a spectral cache dict: each plane becomes an int8 / uint8
    plane plus ``<name>_s``.  An already-quantized dict passes through."""
    if any(k + SCALE_SUFFIX in cache for k in PLANE_NAMES):
        return dict(cache)
    out = {}
    for name, w in cache.items():
        if name in PLANE_NAMES:
            out[name], out[name + SCALE_SUFFIX] = quantize_plane(w, bits)
        else:
            out[name] = w
    return out


def plane_from_cache(cache: Dict[str, torch.Tensor], name: str, kf: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One plane ready to contract: (float32 plane, fold-scale or None).
    Packed int4 planes are unpacked to ``kf`` nibbles first."""
    w = cache[name]
    scale = cache.get(name + SCALE_SUFFIX)
    if scale is None:
        return w, None
    if w.dtype == torch.uint8:
        w = unpack_int4(w, kf)
    return w.float(), scale


def baked_caches(params: nn.Module):
    """Every baked spectral cache of ``params``, as ``(module path, module,
    prefix, cache)``: the module keeps plane ``name`` in its buffer
    ``<prefix>_<name>``.  A module offers its caches through
    ``plane_caches()`` (``{prefix: cache}``): a ``core/circulant.py:Linear``
    its ``wc_cache``, an MoE's ``layers/ffn.py:Experts`` the
    ``{up,gate,down}_cache`` stacks ((E, p, q, kf) planes), and under
    projection fusion an ``Attention`` its ``qkv_cache`` and a gated
    ``MLP`` its ``upgate_cache`` ((Σp_i, q, kf) planes)."""
    for name, m in params.named_modules():
        caches = getattr(m, "plane_caches", None)
        if caches is None:
            continue
        for prefix, cache in caches().items():
            if "wr" in cache:
                yield name, m, prefix, cache


def quantize_serving_params(params: nn.Module, bits: int = 8) -> nn.Module:
    """Quantize every baked spectral cache of ``params`` IN PLACE: each
    plane buffer ``<prefix>_<plane>`` becomes int8 (or packed uint8) and
    ``<prefix>_<plane>_s`` holds its per-block-row scales ((p, 1), (Σp_i,
    1) on fused planes, or (E, p, 1) on an expert stack).  Generators and dense weights are
    untouched.  Idempotent; returns ``params``."""
    for _, m, prefix, cache in baked_caches(params):
        for key, t in quantize_plane_cache(cache, bits).items():
            setattr(m, f"{prefix}_{key}", t)
    return params


def plane_clip_report(params: nn.Module) -> Dict[str, int]:
    """Saturation census over every quantized plane of ``params``:
    ``{"clipped", "total", "planes"}``.  Packed int4 planes count against
    the int4 rail, the odd-length pad nibble as unclipped.  An expert
    stack's (E, p, q, kf) plane counts as one plane."""
    counts = {"clipped": 0, "total": 0, "planes": 0}
    for _, _, _, cache in baked_caches(params):
        for name in PLANE_NAMES:
            if name not in cache or name + SCALE_SUFFIX not in cache:
                continue
            plane = cache[name]
            if plane.dtype == torch.uint8:
                q, qmax = unpack_int4(plane, 2 * plane.shape[-1]), INT4_QMAX
            else:
                q, qmax = plane, INT8_QMAX
            clipped, total = saturation_counts(q, qmax)
            counts["clipped"] += int(clipped)
            counts["total"] += total
            counts["planes"] += 1
    return counts


# ---------------------------------------------------------------------------
# Paged KV pool: per-page-per-head quantization
# ---------------------------------------------------------------------------
def quantize_page_block(vals: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-page quantization for the prefill pack: (..., page, H, D) ->
    (int8 of the same shape, (..., H) float32 scales), one scale per
    (page, head) over the in-page offset and head-dim axes."""
    scale = absmax_scale(vals, axes=(-3, -1))
    q = quantize(vals, scale[..., None, :, None])
    return q, scale.float()


def page_scatter(pool_q: torch.Tensor, scales: torch.Tensor,
                 pid: torch.Tensor, off: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode write of one token per slot into an int8 page pool, IN PLACE.

    pool_q: (P, page, H, D) int8; scales: (P, H) float32; pid / off: (B,)
    page id and in-page offset per slot; x: (B, H, D) new K or V rows.
    Returns (pool_q, scales), the same storage.

    A page's scale only grows: ``s_new = max(s_old, absmax(x) / 127)`` per
    head, and the page's resident codes are requantized to it.  ``repro``
    runs the requantize under ``lax.cond`` on "any scale grew"; here it runs
    unconditionally, so no device value is read on the host.  Where no scale
    grew, ``ratio`` is exactly 1.0 and ``round(q * 1.0) == q``: the result
    is bit-identical to ``repro``'s single-row fast path.  (A page whose
    scale is 0 holds only zero codes, so ``ratio = 0`` there changes
    nothing.)  The cost is a read-modify-write of B whole pages per layer
    and plane instead of B rows.  Idle slots carry pid 0, the trash page;
    their duplicate writes are unordered and never read unmasked.
    """
    page = pool_q.shape[1]
    s_old = scales[pid]                                         # (B, H)
    s_new = torch.maximum(s_old, absmax_scale(x, axes=-1))      # (B, H)
    ratio = s_old / torch.clamp(s_new, min=_EPS)                # <= 1
    resident = torch.round(pool_q[pid].float()
                           * ratio[:, None, :, None]).to(torch.int8)
    tok = quantize(x, s_new[..., None])                         # (B, H, D)
    hit = torch.arange(page, device=off.device)[None, :] == off[:, None]
    resident = torch.where(hit[..., None, None], tok[:, None], resident)
    pool_q[pid] = resident
    scales[pid] = s_new
    return pool_q, scales
