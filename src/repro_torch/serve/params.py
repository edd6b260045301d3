"""Offline spectral-weight precomputation for serving (port of
``repro/serve/params.py``).

The serve hot path runs input DFT → spectral MAC → iDFT with no weight
transform in the loop: ``precompute_serving_params`` FFTs every
block-circulant generator that serves through the spectral path once and
stores the planes beside it (``Linear.wc_cache``).  With a ``QuantPolicy``
whose ``quant_weights`` is set, the planes are then quantized to int8 (or
packed int4) with per-block-row scales.  Unlike ``repro``'s pure tree
transform, it bakes (and quantizes) the planes into the module IN PLACE and
returns it; it is idempotent.

Not ported yet: the fused ``qkv_cache`` / ``upgate_cache`` planes and the
per-expert caches.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import circulant as cc
from ..quant.codec import (SCALE_SUFFIX, QuantPolicy, baked_linears,
                           quantize_serving_params)


def _spectral_at_serve(comp, k: int) -> bool:
    """Whether a block-size-k projection serves through the spectral path
    (the dispatch ``apply_linear`` runs)."""
    if not k:
        return False
    spec = cc.LinearSpec("block_circulant", k, comp.path, comp.gauss_trick)
    return spec.resolve_path("serve") == "spectral"


def _baked_bits(params: nn.Module):
    """The bits of the planes already baked into ``params``: None (float32
    planes or none baked), 8 or 4."""
    for _, _, cache in baked_linears(params):
        if "wr" + SCALE_SUFFIX in cache:
            return 4 if cache["wr"].dtype == torch.uint8 else 8
        return None
    return None


def precompute_serving_params(params: nn.Module, cfg: ArchConfig,
                              policy: QuantPolicy = None) -> nn.Module:
    """Bake (and, under ``policy.quant_weights``, quantize) the spectral
    planes of ``params`` in place.  Because the module is changed in place,
    it raises if the planes already baked into it are quantized otherwise
    than ``policy`` asks: a float-plane engine needs fresh params."""
    comp = cfg.compression
    if not comp.enabled:
        return params
    if getattr(comp, "fuse_projections", False):
        raise NotImplementedError("fused qkv/upgate planes are not ported yet")
    want = (policy.weight_bits if policy is not None and policy.quant_weights
            else None)
    have = _baked_bits(params)
    if have is not None and have != want:
        raise ValueError(f"params carry int{have} spectral planes, the "
                         f"policy asks for "
                         f"{'float32' if want is None else f'int{want}'} "
                         f"planes (planes are quantized in place)")
    for m in params.modules():
        if (isinstance(m, cc.Linear) and m.spec.kind == "block_circulant"
                and _spectral_at_serve(comp, m.spec.block_size)):
            m.bake_spectral(comp.gauss_trick)
    if want is not None:
        quantize_serving_params(params, want)
    return params
