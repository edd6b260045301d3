"""Carry ``repro`` weights into the port.

``from_jax_params(tree, cfg)`` takes ``repro``'s raw parameter tree with
numpy leaves (the caller converts, e.g. ``jax.tree.map(np.asarray,
params)``; this package never imports JAX) and returns the port's
``Transformer``.  Each segment's scan axis is unstacked into per-layer
modules.  Leaves are copied (``np.array``): ``np.asarray`` of a JAX array
is read-only.

Baked per-projection planes (``wc_cache``, float32 or quantized: int8 /
packed-int4 ``uint8`` planes with ``<name>_s`` scales) are carried into the
``Linear``'s ``wc_cache_*`` buffers in their own dtype, so both packages
can serve bit-identical planes; ``precompute_serving_params`` then leaves
them as they are.  The fused ``qkv_cache`` / ``upgate_cache`` planes are
not ported and are skipped (the port bakes its own per-projection planes).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.circulant import CACHE_KEYS
from ..device import resolve_device
from .transformer import Transformer, segments_for

_SKIP = ("qkv_cache", "upgate_cache")


def _copy_into(module: torch.nn.Module, tree: Mapping[str, Any], index,
               where: str) -> None:
    """Copy ``tree`` (a dict of numpy leaves or sub-dicts, indexed by
    ``index`` on the stacked axis) into ``module``'s parameters of the same
    names."""
    for name, node in tree.items():
        if name in _SKIP:
            continue
        path = f"{where}.{name}" if where else name
        if name == "wc_cache":
            _copy_planes(module, node, index, path)
            continue
        if isinstance(node, Mapping):
            _copy_into(getattr(module, name), node, index, path)
            continue
        target = getattr(module, name)
        arr = np.array(node if index is None else node[index],
                       dtype=np.float32)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path}: repro shape {arr.shape} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(arr))


def _copy_planes(module: torch.nn.Module, cache: Mapping[str, Any], index,
                 where: str) -> None:
    """Copy a baked ``wc_cache`` dict into ``module``'s plane buffers,
    keeping each leaf's dtype."""
    unknown = set(cache) - set(CACHE_KEYS)
    if unknown:
        raise ValueError(f"{where}: unknown plane keys {sorted(unknown)}")
    device = module.wc.device
    for key, node in cache.items():
        arr = np.array(node if index is None else node[index])
        setattr(module, f"wc_cache_{key}",
                torch.from_numpy(arr).to(device))


def from_jax_params(tree: Mapping[str, Any], cfg: ArchConfig,
                    device=None) -> Transformer:
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    _copy_into(model, {"embed": tree["embed"],
                       "final_norm": tree["final_norm"]}, None, "")
    layer = 0
    for seg, (pattern, n) in zip(tree["segments"], segments_for(cfg)):
        for g in range(n):
            for bi, _ in enumerate(pattern):
                _copy_into(model.blocks[layer], seg[bi], g,
                           f"blocks.{layer}")
                layer += 1
    if layer != len(model.blocks):
        raise ValueError(f"tree holds {layer} layers, {cfg.name} has "
                         f"{len(model.blocks)}")
    return model
