"""Paged KV gather: block table -> contiguous KV view (port of
``repro/kernels/paged.py``).

``paged_gather`` is the wrapper: on CUDA tensors it launches
``csrc/paged_gather.cu`` (or raises), on CPU tensors it runs
``paged_gather_plain``, ``pool[table]``.  The copy is dtype-blind: float32,
bfloat16 and int8 pools take the same kernel.

This is the parity ORACLE path (``ContinuousEngine(paged_attn="gather")``):
the serving default streams pages through the paged flash-decode kernel and
never forms this view.
"""
from __future__ import annotations

import ctypes

import torch

from .build import Kernel, check_cuda, ptr

_VP, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_gather", {
    "paged_gather": [_VP] * 3 + [_I] * 3 + [ctypes.c_longlong]})
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def paged_gather_plain(pool: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
    """pool (P, page, H, D), table (B, maxp) -> (B, maxp * page, H, D)."""
    _, page, H, D = pool.shape
    B, maxp = table.shape
    return pool[table.long()].reshape(B, maxp * page, H, D)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Slot ``b``'s pages concatenated in table order: position ``i`` of
    slot ``b`` is page ``table[b, i // page]``, offset ``i % page``."""
    if pool.device.type == "cpu":
        return paged_gather_plain(pool, table)
    device = check_cuda("paged_gather", {"pool": pool, "table": table},
                        {"pool": POOL_DTYPES, "table": (torch.int32,)})
    P, page, H, D = pool.shape
    B, maxp = table.shape
    out = torch.empty((B, maxp * page, H, D), dtype=pool.dtype,
                      device=device)
    KERNEL.launch("paged_gather", device, ptr(pool), ptr(table), ptr(out),
                  B, maxp, P, page * H * D * pool.element_size())
    return out
