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

The dry run's inputs (``repro``'s ``train_batch_specs``,
``prefill_batch_specs``, ``cache_specs``, ``input_specs``) are fake
tensors (``torch._subclasses.fake_tensor``): the shapes and dtypes of
``repro``'s ``ShapeDtypeStruct``s with no storage, made in the fake mode
the caller passes (a new one by default).  ``abstract_params`` builds
the model itself that way, at full size: llama4-maverick's 400B
parameters cost nothing.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
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


# ---------------------------------------------------------------------------
# Fake-tensor stand-ins for the dry run (no allocation)
# ---------------------------------------------------------------------------
def fake_mode():
    """A fresh fake-tensor mode (tensors with shapes, dtypes and devices
    and no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


@contextlib.contextmanager
def _in(mode):
    """``mode`` entered unless it is already the innermost active one."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    if _get_current_dispatch_mode() is mode:
        yield
    else:
        with mode:
            yield


def _frontend(batch: Dict, cfg: ArchConfig, B: int) -> Dict:
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model))
    elif cfg.frontend == "vision_stub":
        batch["patches"] = torch.empty((B, cfg.num_patches, cfg.d_model))
    return batch


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, mode=None) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    with _in(mode or fake_mode()):
        return _frontend({"tokens": torch.empty((B, S), dtype=torch.int32),
                          "labels": torch.empty((B, S), dtype=torch.int32)},
                         cfg, B)


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                        mode=None) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    with _in(mode or fake_mode()):
        return _frontend({"tokens": torch.empty((B, S), dtype=torch.int32)},
                         cfg, B)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                mode=None) -> Any:
    """The cache ``Model.init_cache`` makes, as fake tensors on the CPU."""
    with _in(mode or fake_mode()):
        return build_model(cfg).init_cache(batch, max_seq, dtype,
                                           device="cpu")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mode=None) -> Dict:
    """All inputs of the step a cell runs, as fake tensors:

    train   -> {"batch": ...}
    prefill -> {"batch": ..., "cache": ...}
    decode  -> {"tokens": (B, 1), "cache": ..., "cache_pos": scalar}

    ``cache_pos`` is a 0-dim int32 tensor, as ``repro``'s; the dry run
    decodes at the cache's last position, a host int."""
    mode = mode or fake_mode()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, mode)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, mode),
                "cache": cache_specs(cfg, B, S, mode=mode)}
    with _in(mode):
        tokens = torch.empty((B, 1), dtype=torch.int32)
        pos = torch.empty((), dtype=torch.int32)
    return {"tokens": tokens, "cache": cache_specs(cfg, B, S, mode=mode),
            "cache_pos": pos}


def abstract_params(cfg: ArchConfig, mode=None) -> torch.nn.Module:
    """The model's module at full size with fake parameters on the CPU
    (zeros in shape only: no generator runs, nothing is allocated)."""
    with _in(mode or fake_mode()):
        dev = torch.device("cpu")
        if cfg.is_encoder_decoder:
            return encdec.EncDec(cfg, device=dev)
        return transformer.Transformer(cfg, device=dev)
