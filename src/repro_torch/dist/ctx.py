"""Activation-sharding context (port of ``repro/dist/ctx.py``): the policy
the model backbones consult at block boundaries.

``activation_policy(mesh, seq_shard=...)`` installs a policy for the
current thread; ``shard_act(x)`` (called between blocks) and
``shard_heads(x)`` (on the paged decode's per-slot q and output) pin an
activation to the policy's layout.  Where ``repro`` adds a
``with_sharding_constraint`` for GSPMD, the port redistributes a
``torch.distributed.tensor.DTensor`` to the placements
``sharding.to_placements`` derives from the same specs.  Everything else
passes through unchanged: outside any policy, a plain tensor (the engines'
activations, on one card), or a rank other than 3.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from . import sharding as sh


class _PolicyState(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _PolicyState()


@contextlib.contextmanager
def activation_policy(mesh, *, seq_shard: bool = False):
    """Install an activation-sharding policy: batch over the DP axes, and,
    with ``seq_shard`` (token parallelism), sequence over "model".
    Policies nest; the innermost wins."""
    _STATE.stack.append((mesh, bool(seq_shard)))
    try:
        yield
    finally:
        _STATE.stack.pop()


def current_policy() -> Optional[Tuple[object, bool]]:
    """The innermost (mesh, seq_shard) policy, or None outside any."""
    return _STATE.stack[-1] if _STATE.stack else None


def _pinned(x: torch.Tensor):
    """The policy's mesh and seq_shard where ``x`` is a rank-3 DTensor
    under a policy, else None (a plain tensor passes through untouched)."""
    if type(x) is torch.Tensor or x.dim() != 3:
        return None
    pol = current_policy()
    from torch.distributed.tensor import DTensor
    return pol if pol is not None and isinstance(x, DTensor) else None


def _pin(x, spec) -> torch.Tensor:
    mesh = x.device_mesh
    return x.redistribute(mesh, sh.to_placements(spec, mesh))


def shard_act(x: torch.Tensor) -> torch.Tensor:
    """Block-boundary pin of a (B, S, d) activation: batch over the DP
    axes (sequence over "model" under ``seq_shard``), divisibility checked
    against the live shape (``sharding.batch_spec``)."""
    pol = _pinned(x)
    if pol is None:
        return x
    mesh, seq_shard = pol
    return _pin(x, sh.batch_spec(x.shape, mesh, x.shape[0],
                                 seq_shard=seq_shard))


def shard_heads(x: torch.Tensor) -> torch.Tensor:
    """Pin of a (B, Hq, D) per-slot decode activation: slots over DP,
    heads over "model" with a head-dim fallback (``sharding.
    decode_head_spec``, the pool's own head placement)."""
    pol = _pinned(x)
    if pol is None:
        return x
    return _pin(x, sh.decode_head_spec(x.shape, pol[0]))
