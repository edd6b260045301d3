"""Paged continuous-batching step builders (port of the paged half of
``repro/serve/decode.py``).

``make_prefill_pack_step`` is the B=1 right-padded prefill plus the page
scatter; ``make_paged_decode_loop`` decodes every slot at its own position
for up to ``chunk`` steps.  ``repro`` runs the decode loop as one device
program (``lax.while_loop``); here it is a host loop over the chunk's
steps, each step a forward pass of kernels on the current stream, with the
same per-slot freeze rules.  Each step reads one bit back to the host
(whether every slot is done), so the loop, like ``repro``'s, ends early.

Not ported yet: sampling (``sample=True`` raises), the numerics capture
side-outputs, and the batch engine's step builders.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..models.registry import build_model
from . import kvcache as kvc


def make_prefill_pack_step(cfg: ArchConfig, n_pages: int,
                           page_size: int) -> Callable:
    """B=1 exact-position prefill + page scatter, one call per admission.

    The prompt is right-padded to ``n_pages * page_size``; causal masking
    keeps positions < S exact, and the padded tail of the cache stays masked
    until decode overwrites it.  The dense prefill cache is float32 and is
    scattered into the pool's dtype.

    An int8 pool is packed with ``true_len`` (the pad tail zeroed before
    the page scales are derived) and with its saturation census.

    Returns ``prefill_pack(params, batch, pool, pages, true_len)`` ->
    ``(first_token, ok, pool, kv_clip)``: the greedy token at the prompt's
    last true position and whether those logits are all finite (device
    scalars), and, for an int8 pool, ``(clipped, total)`` of the values it
    wrote (device scalars; None for other pools).
    """
    model = build_model(cfg)
    spad = n_pages * page_size

    def prefill_pack(params, batch, pool, pages, true_len: int):
        device = batch["tokens"].device
        cache = model.init_cache(1, spad, dtype=torch.float32, device=device)
        logits, dense = model.prefill(params, batch, cache)
        last = logits[0, true_len - 1]
        ok = torch.isfinite(last).all()
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        kv_clip = None
        if "k_scale" in pool:
            pool, clipped, total = kvc.pack_prefill_cache(
                pool, dense, pages, page_size, true_len=true_len,
                with_stats=True)
            kv_clip = (clipped, total)
        else:
            pool = kvc.pack_prefill_cache(pool, dense, pages, page_size,
                                          true_len=true_len)
        return nxt, ok, pool, kv_clip
    return prefill_pack


def make_paged_decode_loop(cfg: ArchConfig, chunk: int, *,
                           sample: bool = False, eos_id: Optional[int] = None,
                           nan_guard: bool = True,
                           paged_impl: str = "stream") -> Callable:
    """Decode over paged slots, up to ``chunk`` steps per call.

    ``paged_impl`` picks the attention lowering of each step: "stream"
    (the paged flash-decode kernel) or "gather" (the parity oracle: gather
    each slot's pages, then a masked softmax).

    Every slot advances at its own position.  A slot freezes when its budget
    reaches zero or it emits ``eos_id``; a frozen slot's writes go to the
    trash page (position -1) and its buffer entries hold ``eos_id`` (or 0).
    With ``nan_guard`` a slot whose logits are not all finite freezes like
    an EOS slot, appends nothing, and is flagged in ``anom``.  The loop
    stops early once every slot is frozen.

    Returns ``decode_loop(params, cur, pool, table, pos, rem)`` ->
    ``(buf (B, chunk), cur, pool, pos, rem, done, anom, steps)``; ``steps``
    is the number of decode steps (forward passes) it ran.
    """
    if sample:
        raise NotImplementedError("sampling is not ported yet (greedy only)")
    model = build_model(cfg)
    fill = 0 if eos_id is None else int(eos_id)

    def decode_loop(params, cur, pool, table, pos, rem):
        B = cur.shape[0]
        done = rem <= 0
        anom = torch.zeros(B, dtype=torch.bool, device=cur.device)
        buf = torch.full((B, chunk), fill, dtype=torch.int32,
                         device=cur.device)
        steps = 0
        for j in range(chunk):
            if bool(done.all()):
                break
            masked = torch.where(done, torch.full_like(pos, -1), pos)
            logits, pool = model.decode_step(params, cur[:, None], pool,
                                             masked, block_table=table,
                                             paged_impl=paged_impl)
            last = logits[:, -1]
            finite = (torch.isfinite(last).all(dim=-1) if nan_guard
                      else torch.ones_like(done))
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
            bad = ~done & ~finite
            halt = done | bad
            buf[:, j] = torch.where(halt, torch.full_like(nxt, fill), nxt)
            pos = torch.where(halt, pos, pos + 1)
            rem = torch.where(halt, rem, rem - 1)
            nd = halt | (rem <= 0)
            if eos_id is not None:
                nd = nd | (~halt & (nxt == eos_id))
            cur = torch.where(halt, cur, nxt)
            done = nd
            anom = anom | bad
            steps += 1
        return buf, cur, pool, pos, rem, done, anom, steps
    return decode_loop
