"""Offline spectral-weight precomputation for serving (port of
``repro/serve/params.py``).

The serve hot path runs input DFT → spectral MAC → iDFT with no weight
transform in the loop: ``precompute_serving_params`` FFTs every
block-circulant generator that serves through the spectral path once and
stores the planes beside it (``Linear.wc_cache``; for an MoE's expert
stacks, the per-expert ``{up,gate,down}_cache`` planes of
``layers/ffn.py:Experts``, (E, p, q, kf) each).  With projection fusion
(``CompressionConfig.fuse_projections``) it bakes, where ``repro``'s
``fusable`` holds, the concatenated q/k/v planes ``qkv_cache`` on each
``Attention`` and up/gate planes ``upgate_cache`` on each gated ``MLP``
(an MoE's shared expert included; expert stacks never fuse), and the
projections they shadow get no planes of their own: one copy of each
plane, as in ``repro``.  With a ``QuantPolicy``
whose ``quant_weights`` is set, the planes are then quantized to int8 (or
packed int4) with per-block-row scales.  Unlike ``repro``'s pure tree
transform, it bakes (and quantizes) the planes into the module IN PLACE and
returns it; it is idempotent.  ``strip_serving_params`` drops them again
(in place) and ``serving_cache_bytes`` counts them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core import circulant as cc
from ..layers.ffn import Experts
from ..quant.codec import (SCALE_SUFFIX, QuantPolicy, baked_caches,
                           quantize_serving_params)


def _spectral_at_serve(comp, k: int) -> bool:
    """Whether a block-size-k projection serves through the spectral path
    (the dispatch ``apply_linear`` runs)."""
    if not k:
        return False
    spec = cc.LinearSpec("block_circulant", k, comp.path, comp.gauss_trick)
    return spec.resolve_path("serve") == "spectral"


def _fusable(comp, m: cc.FusedProjections) -> bool:
    """Whether the fused serve path shadows ``m``'s projections
    (``repro``'s ``fusable``): fusion on, not cross-attention, every
    projection block-circulant with one input-block shape, served
    spectrally."""
    lins = m.fused_linears()
    return (getattr(comp, "fuse_projections", False) and m.may_fuse
            and all(lin is not None and lin.spec.kind == "block_circulant"
                    for lin in lins)
            and len({tuple(lin.wc.shape[-2:]) for lin in lins}) == 1
            and _spectral_at_serve(comp, lins[0].spec.block_size))


def _baked_bits(params: nn.Module):
    """The bits of the planes already baked into ``params``: None (float32
    planes or none baked), 8 or 4."""
    for _, _, _, cache in baked_caches(params):
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
    want = (policy.weight_bits if policy is not None and policy.quant_weights
            else None)
    have = _baked_bits(params)
    if have is not None and have != want:
        raise ValueError(f"params carry int{have} spectral planes, the "
                         f"policy asks for "
                         f"{'float32' if want is None else f'int{want}'} "
                         f"planes (planes are quantized in place)")
    shadowed = set()                      # ids of the fused projections
    for m in params.modules():
        if isinstance(m, cc.FusedProjections) and _fusable(comp, m):
            m.bake_fused(comp.gauss_trick)
            shadowed.update(map(id, m.fused_linears()))
    for m in params.modules():
        if isinstance(m, cc.Linear):
            if id(m) in shadowed:
                continue
            k = m.spec.block_size if m.spec.kind == "block_circulant" else 0
        elif isinstance(m, Experts):
            k = m.block_size
        else:
            continue
        if _spectral_at_serve(comp, k):
            m.bake_spectral(comp.gauss_trick)
    if want is not None:
        quantize_serving_params(params, want)
    return params


def strip_serving_params(params: nn.Module) -> nn.Module:
    """Drop every baked serving cache (the inverse of the precompute pass),
    in place: the module keeps its generators and dense weights only.
    Returns ``params``."""
    cc.drop_planes(params)
    return params


def serving_cache_bytes(params: nn.Module) -> int:
    """Bytes of the baked spectral planes and their scales (``repro``'s
    reporting count)."""
    return sum(t.numel() * t.element_size()
               for _, _, _, cache in baked_caches(params)
               for t in cache.values())
