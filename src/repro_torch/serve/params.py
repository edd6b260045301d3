"""Offline spectral-weight precomputation for serving (port of
``repro/serve/params.py``).

The serve hot path runs input DFT → spectral MAC → iDFT with no weight
transform in the loop: ``precompute_serving_params`` FFTs every
block-circulant generator that serves through the spectral path once and
stores the planes beside it (``Linear.wc_cache``).  Unlike ``repro``'s pure
tree transform, it bakes the planes into the module IN PLACE and returns
it; it is idempotent.

Not ported yet: the fused ``qkv_cache`` / ``upgate_cache`` planes, the
per-expert caches, and quantized planes.
"""
from __future__ import annotations

from torch import nn

from ..configs.base import ArchConfig
from ..core import circulant as cc


def _spectral_at_serve(comp, k: int) -> bool:
    """Whether a block-size-k projection serves through the spectral path
    (the dispatch ``apply_linear`` runs)."""
    if not k:
        return False
    spec = cc.LinearSpec("block_circulant", k, comp.path, comp.gauss_trick)
    return spec.resolve_path("serve") == "spectral"


def precompute_serving_params(params: nn.Module, cfg: ArchConfig,
                              policy=None) -> nn.Module:
    comp = cfg.compression
    if policy is not None:
        raise NotImplementedError("quantized serving planes are not ported "
                                  "yet")
    if not comp.enabled:
        return params
    if getattr(comp, "fuse_projections", False):
        raise NotImplementedError("fused qkv/upgate planes are not ported yet")
    for m in params.modules():
        if (isinstance(m, cc.Linear) and m.spec.kind == "block_circulant"
                and _spectral_at_serve(comp, m.spec.block_size)):
            m.bake_spectral(comp.gauss_trick)
    return params
