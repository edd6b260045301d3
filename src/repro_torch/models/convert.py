"""Carry ``repro`` weights into the port.

``from_jax_params(tree, cfg)`` takes ``repro``'s raw parameter tree with
numpy leaves (the caller converts, e.g. ``jax.tree.map(np.asarray,
params)``; this package never imports JAX) and returns the port's
``Transformer``, or for an encoder-decoder config its ``EncDec``.  Each
segment's scan axis (an encoder-decoder's ``enc_blocks`` / ``dec_blocks``
layer axis) is unstacked into per-layer modules.  Every leaf is carried by
name, ``qwen``'s dense q/k/v biases (``b``) and per-head qk-norm scales
(``qn`` / ``kn``) included; the one name that differs is a decoder
block's self-attention, ``repro``'s ``self`` and the port's
``self_attn``.  Leaves are copied (``np.array``): ``np.asarray`` of a JAX
array is read-only.

An MoE block's ``moe`` subtree is carried the same way: ``router``, the
expert stacks ``experts/{up,gate,down}`` and the shared expert ``shared``;
so is an xLSTM block's ``cell`` (the mLSTM's projections, ``ifg``,
``ifg_b`` and ``onorm_scale``; the sLSTM's ``wx``, ``wh``, ``b`` and
``out``), a ``rec`` block's RG-LRU ``rec`` (``in_x``, ``in_gate``,
``out``, ``gate_r``, ``gate_i``, ``conv_w``, ``conv_b``, ``lam``),
gemma2's sandwich norms ``ln1_post`` / ``ln2_post``, a decoder-only
model's learned position table ``pos`` (where ``max_position`` is set),
and an encoder-decoder's ``enc_pos`` / ``dec_pos`` tables and
``enc_norm``.
A segment plan's remainder segment (recurrentgemma's 26 layers: 8 x
(rec, rec, attn_local), then (rec, rec)) is walked like any other.

Baked planes (a projection's ``wc_cache``, an expert stack's
``{up,gate,down}_cache``, projection fusion's ``qkv_cache`` on an
attention block and ``upgate_cache`` on a gated MLP; float32 or quantized:
int8 / packed-int4 ``uint8`` planes with ``<name>_s`` scales) are carried
into the module's ``<cache>_*`` buffers in their own dtype, so both
packages can serve bit-identical planes; ``precompute_serving_params``
then leaves them as they are.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.circulant import CACHE_KEYS
from ..device import resolve_device
from .encdec import EncDec
from .transformer import Transformer, segments_for

_PLANE_DICTS = ("wc_cache", "up_cache", "gate_cache", "down_cache",
                "qkv_cache", "upgate_cache")
_RENAMES = {"self": "self_attn"}          # repro's name -> the port's


def _copy_into(module: torch.nn.Module, tree: Mapping[str, Any], index,
               where: str) -> None:
    """Copy ``tree`` (a dict of numpy leaves or sub-dicts, indexed by
    ``index`` on the stacked axis) into ``module``'s parameters of the same
    names."""
    for name, node in tree.items():
        path = f"{where}.{name}" if where else name
        if name in _PLANE_DICTS:
            _copy_planes(module, name, node, index, path)
            continue
        if isinstance(node, Mapping):
            _copy_into(getattr(module, _RENAMES.get(name, name)), node,
                       index, path)
            continue
        target = getattr(module, name)
        arr = np.array(node if index is None else node[index],
                       dtype=np.float32)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path}: repro shape {arr.shape} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(arr))


def _copy_planes(module: torch.nn.Module, prefix: str,
                 cache: Mapping[str, Any], index, where: str) -> None:
    """Copy a baked cache dict into ``module``'s plane buffers
    ``<prefix>_<plane>``, keeping each leaf's dtype."""
    unknown = set(cache) - set(CACHE_KEYS)
    if unknown:
        raise ValueError(f"{where}: unknown plane keys {sorted(unknown)}")
    device = next(module.parameters()).device
    for key, node in cache.items():
        arr = np.array(node if index is None else node[index])
        setattr(module, f"{prefix}_{key}", torch.from_numpy(arr).to(device))


def from_jax_params(tree: Mapping[str, Any], cfg: ArchConfig,
                    device=None):
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        model = EncDec(cfg, device=device)
        _copy_into(model, {k: tree[k] for k in ("embed", "enc_pos", "dec_pos",
                                                "enc_norm", "final_norm")},
                   None, "")
        for name in ("enc_blocks", "dec_blocks"):
            for i, block in enumerate(getattr(model, name)):
                _copy_into(block, tree[name], i, f"{name}.{i}")
        return model
    model = Transformer(cfg, device=device)
    _copy_into(model, {k: tree[k] for k in ("embed", "final_norm", "pos")
                       if k in tree}, None, "")
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
