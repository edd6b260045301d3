"""Model API over the decoder LM and the encoder-decoder (port of
``repro/models/registry.py:Model``).

    init(seed, device)                                -> params (nn.Module)
    forward_train(params, batch)                      -> (logits, aux)
    prefill(params, batch, cache, kernel_fn)          -> (logits, cache)
    decode_step(params, tokens, cache, pos, table, paged_impl)
                                                      -> (logits, cache)
    init_cache(batch, max_seq, dtype, device)         -> cache

``batch`` holds ``tokens`` and the stub frontend's input: for a
``vision_stub`` config ``patches`` (B, num_patches, d_model), which replace
the first token slots; for an encoder-decoder (``audio_stub``) ``frames``
(B, encoder_seq, d_model), which the encoder takes.  ``decode_step``
decodes against a dense cache (``pos`` an int, no table: the batch engine)
or a page pool (``pos`` a (B,) vector and a block table: the continuous
engine; decoder LMs only).  An encoder-decoder's cache is ``{"self",
"cross"}``: prefill encodes the frames and fills both, a decode step
carries ``cross`` unchanged.  ``kernel_fn`` is the projections'
spectral-MAC hook (``core/circulant.py``).  Caches are updated in place
and returned.  ``forward_train`` runs any arch in train mode: the decoder
LM (``models/transformer.py``; ``aux["moe_aux"]`` the sum of its MoE
blocks' load-balancing losses, 0 without any) or the encoder-decoder on
``batch["frames"]`` (``models/encdec.py:forward_train``; ``moe_aux`` 0,
as in ``repro``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import encdec, transformer


class Model:
    """Thin dispatch; the math lives in ``models/transformer.py`` and
    ``models/encdec.py``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, device=None) -> torch.nn.Module:
        if self.cfg.is_encoder_decoder:
            return encdec.init_params(self.cfg, seed=seed, device=device)
        return transformer.init_params(self.cfg, seed=seed, device=device)

    def forward_train(self, params, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            logits = encdec.forward_train(params, batch["tokens"],
                                          batch["frames"], cfg)
            return logits, {"moe_aux": torch.zeros((), device=logits.device)}
        logits, aux = transformer.forward(
            params, batch["tokens"], cfg, mode="train",
            frontend_embeds=batch.get("patches"))
        return logits, {"moe_aux": aux}

    def prefill(self, params, batch: Dict[str, torch.Tensor], cache,
                kernel_fn=None) -> Tuple[torch.Tensor, Any]:
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc = encdec.encode(params, batch["frames"], cfg,
                                kernel_fn=kernel_fn)
            encdec.all_cross_kv(params, enc, cfg, cache["cross"],
                                kernel_fn=kernel_fn)
            logits = encdec.decode(params, batch["tokens"], cfg,
                                   cross=cache["cross"], cache=cache["self"],
                                   cache_pos=0, kernel_fn=kernel_fn)
            return logits, cache
        return transformer.forward(params, batch["tokens"], cfg,
                                   mode="serve", cache=cache, cache_pos=0,
                                   kernel_fn=kernel_fn,
                                   frontend_embeds=batch.get("patches"))

    def decode_step(self, params, tokens: torch.Tensor, cache, cache_pos,
                    block_table: Optional[torch.Tensor] = None,
                    paged_impl: str = "stream") -> Tuple[torch.Tensor, Any]:
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            if block_table is not None:
                raise ValueError("paged decode is decoder-LM only")
            logits = encdec.decode(params, tokens, cfg, cross=cache["cross"],
                                   cache=cache["self"], cache_pos=cache_pos)
            return logits, cache
        return transformer.forward(params, tokens, cfg, mode="serve",
                                   cache=cache, cache_pos=cache_pos,
                                   block_table=block_table,
                                   paged_impl=paged_impl)

    def init_cache(self, batch: int, max_seq: int, dtype=None, device=None):
        if dtype is None:
            dtype = getattr(torch, self.cfg.kv_cache_dtype)
        init = (encdec.init_cache if self.cfg.is_encoder_decoder
                else transformer.init_cache)
        return init(self.cfg, batch, max_seq, device=device, dtype=dtype)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None
                ) -> torch.nn.Module:
    """Random serving weights for any ported arch (``Model.init``)."""
    return build_model(cfg).init(seed=seed, device=device)
