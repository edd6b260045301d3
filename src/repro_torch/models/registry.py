"""Model API over the decoder LM (port of ``repro/models/registry.py:Model``).

    init(seed, device)                                -> params (nn.Module)
    prefill(params, batch, cache)                     -> (logits, cache)
    decode_step(params, tokens, cache, pos, table, paged_impl)
                                                      -> (logits, cache)
    init_cache(batch, max_seq, dtype, device)         -> cache

Caches are updated in place and returned.  Not ported yet: the
encoder-decoder backbone and the training forward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import transformer


class Model:
    """Thin dispatch; the math lives in ``models/transformer.py``."""

    def __init__(self, cfg: ArchConfig):
        if cfg.is_encoder_decoder:
            raise NotImplementedError("encoder-decoder models are not ported "
                                      "yet")
        self.cfg = cfg

    def init(self, seed: int = 0, device=None) -> transformer.Transformer:
        return transformer.init_params(self.cfg, seed=seed, device=device)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache) -> Tuple[torch.Tensor, Any]:
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   mode="serve", cache=cache, cache_pos=0)

    def decode_step(self, params, tokens: torch.Tensor, cache, cache_pos,
                    block_table: Optional[torch.Tensor] = None,
                    paged_impl: str = "stream") -> Tuple[torch.Tensor, Any]:
        return transformer.forward(params, tokens, self.cfg, mode="serve",
                                   cache=cache, cache_pos=cache_pos,
                                   block_table=block_table,
                                   paged_impl=paged_impl)

    def init_cache(self, batch: int, max_seq: int, dtype=None, device=None):
        if dtype is None:
            dtype = getattr(torch, self.cfg.kv_cache_dtype)
        return transformer.init_cache(self.cfg, batch, max_seq, device=device,
                                      dtype=dtype)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
