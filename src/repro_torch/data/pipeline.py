"""Deterministic, stateless-resumable data (port of
``repro/data/pipeline.py``).

The batch of step ``i`` is a pure function of ``(seed, i)``: nothing to
checkpoint, and any host can recompute any shard.  Two sources, both
yielding ``{"tokens", "labels"}`` (int32, (B, S), labels the next tokens)
on the CPU, plus the stub frontend's input (``_add_frontend``):

* ``SyntheticLM``: token streams with a learnable bigram structure (a
  fixed random successor table; each next token is the successor with
  probability 0.9, else uniform).  Its random draws come from numpy's
  ``default_rng((seed, step))``, not ``jax.random``, so the bits differ
  from ``repro``'s; the contract is the same.
* ``FileTokens``: a memory-mapped flat token file, deterministic strided
  windows wrapping circularly; the same tokens as ``repro``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng((seed, step))


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    vocab_cap: int = 0              # sample ids < cap (default: vocab_size)

    def __post_init__(self):
        cap = self.vocab_cap or self.cfg.vocab_size
        rng = np.random.RandomState(self.seed)
        # the fixed bigram successor table (repro's, bit for bit)
        self._succ = rng.randint(0, cap, size=(cap,)).astype(np.int32)
        self._cap = cap

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        rng = _rng(self.seed, step)
        first = rng.integers(0, self._cap, size=(self.batch,))
        noise = rng.random((self.batch, self.seq)) < 0.1
        rand = rng.integers(0, self._cap, size=(self.batch, self.seq))
        seq = np.empty((self.batch, self.seq), dtype=np.int64)
        tok = first
        for t in range(self.seq):
            tok = np.where(noise[:, t], rand[:, t], self._succ[tok])
            seq[:, t] = tok
        toks = np.concatenate([first[:, None], seq[:, :-1]], axis=1)
        batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
                 "labels": torch.from_numpy(seq.astype(np.int32))}
        return _add_frontend(batch, self.cfg, rng)


@dataclasses.dataclass
class FileTokens:
    cfg: ArchConfig
    path: str
    batch: int
    seq: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._mm)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        span = self.seq + 1
        starts = ((step * self.batch + np.arange(self.batch)) * span +
                  self.seed) % max(self._n - span, 1)
        rows = np.stack([np.asarray(self._mm[s:s + span]) for s in starts])
        rows = rows.astype(np.int32) % self.cfg.vocab_size
        batch = {"tokens": torch.from_numpy(rows[:, :-1].copy()),
                 "labels": torch.from_numpy(rows[:, 1:].copy())}
        return _add_frontend(batch, self.cfg, _rng(self.seed, step))


def _add_frontend(batch: Dict, cfg: ArchConfig, rng: np.random.Generator
                  ) -> Dict:
    """The stub frontends' inputs, N(0, 0.02^2): ``frames`` (B,
    encoder_seq, d_model) for ``audio_stub``, ``patches`` (B, num_patches,
    d_model) for ``vision_stub``."""
    B = batch["tokens"].shape[0]
    if cfg.frontend == "audio_stub":
        shape, key = (B, cfg.encoder_seq, cfg.d_model), "frames"
    elif cfg.frontend == "vision_stub":
        shape, key = (B, cfg.num_patches, cfg.d_model), "patches"
    else:
        return batch
    batch[key] = torch.from_numpy(
        (0.02 * rng.standard_normal(shape)).astype(np.float32))
    return batch


def shard_for_host(batch: Dict, host_index: int, num_hosts: int) -> Dict:
    """The per-host rows of a global batch (multi-host launch)."""
    def one(x):
        per = x.shape[0] // num_hosts
        return x[host_index * per:(host_index + 1) * per]
    return {k: one(v) for k, v in batch.items()}
