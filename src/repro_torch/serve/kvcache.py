"""Paged KV-cache pool: fixed-size pages, per-slot block tables, and a
free-list allocator (port of ``repro/serve/kvcache.py``).

* The pool is one ``(L, num_pages, page_size, Hkv, D)`` tensor for K and one
  for V, stacked over the attention layers; a logical page id is valid for
  the whole stack.
* A request owns an ordered list of page ids; position ``i`` lives at page
  ``table[i // page_size]``, offset ``i % page_size``.
* Page id 0 is the TRASH page: never allocated, it absorbs the writes of
  idle and frozen decode slots.

``PageAllocator`` and ``BlockTable`` are plain host code.  The pool is
written in place: ``pack_prefill_cache`` scatters a prefill's dense cache
into its pages, the paged attention branch writes one position per slot
per decode step.

The pool's storage dtype comes from a ``QuantPolicy`` (``kv_dtype`` "f32",
"bf16" or "int8").  An int8 pool carries one float32 absmax scale per
(layer, page, KV head) beside K and V (``k_scale`` / ``v_scale``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..quant.codec import QuantPolicy, quantize_page_block

TRASH_PAGE = 0


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold ``n_positions`` cache slots."""
    return max(1, -(-int(n_positions) // page_size))


class PageAllocator:
    """LIFO free list over ``num_pages`` pages; page 0 (trash) is reserved.

    ``alloc`` returns None when the pool cannot satisfy the request.
    ``fault`` is an optional hook (``fault(n) -> bool``, ``serve/faults.py``):
    when it returns True an alloc fails as if the pool were empty.
    ``free`` raises on a double free, on a page the allocator never handed
    out, and on the trash page.  With a metrics ``registry`` it keeps the
    ``pool.free_pages`` gauge and the ``pool.pages_alloc`` /
    ``pool.pages_freed`` counters current.
    """

    def __init__(self, num_pages: int, registry=None, fault=None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash)")
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._held: set = set()
        self.fault = fault
        self._free_gauge = self._alloc_ctr = self._freed_ctr = None
        if registry is not None:
            self._free_gauge = registry.gauge("pool.free_pages")
            self._free_gauge.set(len(self._free))
            self._alloc_ctr = registry.counter("pool.pages_alloc")
            self._freed_ctr = registry.counter("pool.pages_freed")

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._held)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        if self.fault is not None and self.fault(n):
            return None                    # injected failure: as if empty
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        if self._alloc_ctr is not None:
            self._alloc_ctr.inc(n)
            self._free_gauge.set(len(self._free))
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("freeing the reserved trash page "
                                 f"{TRASH_PAGE}")
            if p not in self._held:
                if 0 < p < self.num_pages:
                    raise ValueError(f"double free of page {p}")
                raise ValueError(f"foreign page {p} (allocator holds "
                                 f"1..{self.num_pages - 1})")
            self._held.discard(p)
            self._free.append(p)
        if self._freed_ctr is not None:
            self._freed_ctr.inc(len(pages))
            self._free_gauge.set(len(self._free))


class BlockTable:
    """Per-slot page ownership over a shared allocator.

    ``table`` is a dense ``(max_slots, max_pages_per_slot)`` int32 array;
    unowned entries hold TRASH_PAGE.  ``reserve`` grows a slot's mapping to
    cover ``n_positions`` (False = pool exhausted, nothing changes);
    ``release`` is idempotent.  ``version`` moves on every change, so the
    engine re-uploads its device copy only when needed.
    """

    def __init__(self, allocator: PageAllocator, max_slots: int,
                 page_size: int, max_pages_per_slot: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.table = np.full((max_slots, max_pages_per_slot), TRASH_PAGE,
                             np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]
        self.version = 0

    def reserve(self, slot: int, n_positions: int) -> bool:
        need = pages_for(n_positions, self.page_size)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_slot "
                f"{self.max_pages_per_slot} (raise max_seq/page budget)")
        extra = need - len(self.owned[slot])
        if extra <= 0:
            return True
        pages = self.allocator.alloc(extra)
        if pages is None:
            return False
        start = len(self.owned[slot])
        self.owned[slot].extend(pages)
        self.table[slot, start:start + extra] = pages
        self.version += 1
        return True

    def release(self, slot: int) -> None:
        if not self.owned[slot]:
            return
        self.allocator.free(self.owned[slot])
        self.owned[slot] = []
        self.table[slot, :] = TRASH_PAGE
        self.version += 1

    def pages(self, slot: int) -> List[int]:
        return list(self.owned[slot])

    def device_table(self, device) -> torch.Tensor:
        return torch.as_tensor(self.table, device=device)

    def utilization(self) -> float:
        usable = self.allocator.num_pages - 1
        return self.allocator.in_use / max(usable, 1)


# ---------------------------------------------------------------------------
# Device pool construction + prefill packing
# ---------------------------------------------------------------------------
def servable_reasons(cfg: ArchConfig) -> List[str]:
    """Why a config can NOT be served by the paged continuous engine
    (empty list = servable), as ``repro`` decides it."""
    from ..models import transformer as tfm
    reasons = []
    if cfg.is_encoder_decoder:
        reasons.append("encoder-decoder (cross-attention cache)")
    if cfg.attention.learned_pos or cfg.max_position:
        reasons.append("learned positions (scalar-position table lookup)")
    kinds = {k for pattern, _ in tfm.segments_for(cfg) for k in pattern}
    bad = kinds - {"attn", "moe"}
    if bad:
        reasons.append(f"block kinds {sorted(bad)} (sliding-window ring "
                       f"buffers / recurrent state)")
    return reasons


def build_pool(cfg: ArchConfig, num_pages: int, page_size: int,
               policy: Optional[QuantPolicy] = None, device=None
               ) -> Dict[str, torch.Tensor]:
    """Zeroed pool ``{"k": (L, num_pages, page_size, Hkv, D), "v": ...}``
    in ``policy.kv_dtype`` (default float32).  An int8 pool adds
    ``k_scale`` / ``v_scale`` of shape (L, num_pages, Hkv), float32, written
    by the prefill pack and the decode page scatter."""
    from ..models import transformer as tfm
    policy = policy or QuantPolicy()
    if servable_reasons(cfg):
        raise ValueError(f"{cfg.name}: not paged-servable: "
                         f"{'; '.join(servable_reasons(cfg))}")
    device = resolve_device(device)
    a = cfg.attention
    L = len(tfm.layer_kinds(cfg))
    shape = (L, num_pages, page_size, a.num_kv_heads, a.head_dim)
    dtype = policy.pool_dtype
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if policy.kv_quantized:
        sshape = (L, num_pages, a.num_kv_heads)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return pool


def pack_prefill_cache(pool: Dict[str, torch.Tensor],
                       dense_cache: Dict[str, torch.Tensor],
                       pages: torch.Tensor, page_size: int,
                       true_len: Optional[int] = None,
                       with_stats: bool = False):
    """Scatter a B=1 dense prefill cache (k/v ``(L, 1, Spad, Hkv, D)``,
    Spad a multiple of ``page_size``) into a slot's pages
    (``(Spad // page_size,)`` ids), in place; returns the pool.

    An int8 pool quantizes each page whole, one absmax scale per
    (page, head).  With ``true_len`` (the unpadded prompt length) the
    right-pad tail is zeroed first, so pad activations do not inflate the
    last page's scale (the tail stays masked on read either way); other
    pools ignore it.  With ``with_stats`` the return is
    ``(pool, clipped, total)``: float32 tensor scalars counting the written
    int8 values at the ±127 rail, and the values written, over valid
    (non-pad) positions only; zeros for other pools."""
    device = pool["k"].device
    clipped = torch.zeros((), dtype=torch.float32, device=device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    idx = pages.long()
    for key in ("k", "v"):
        leaf = dense_cache[key]
        n, _, spad, hkv, d = leaf.shape
        npg = spad // page_size
        vals = leaf.reshape(n, npg, page_size, hkv, d)
        if key + "_scale" not in pool:
            pool[key][:, idx] = vals.to(pool[key].dtype)
            continue
        valid = None
        if true_len is not None:
            valid = (torch.arange(spad, device=leaf.device)
                     < true_len).reshape(npg, page_size)
            vals = torch.where(valid[None, :, :, None, None], vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))
        qvals, scales = quantize_page_block(vals)
        if with_stats:
            sat = qvals.to(torch.int32).abs() >= 127
            if valid is not None:
                sat = sat & valid[None, :, :, None, None]
                total += valid.sum().float() * n * hkv * d
            else:
                total += float(qvals.numel())
            clipped += sat.sum().float()
        pool[key][:, idx] = qvals
        pool[key + "_scale"][:, idx] = scales
    if with_stats:
        return pool, clipped, total
    return pool


def pool_bytes(pool: Dict[str, torch.Tensor]) -> int:
    """Bytes of the pool, scales included."""
    return sum(t.numel() * t.element_size() for t in pool.values())


def page_bytes(cfg: ArchConfig, page_size: int,
               policy: Optional[QuantPolicy] = None) -> int:
    """Bytes one page costs across the whole stack (scales included); built
    on the ``meta`` device, so nothing is allocated."""
    return pool_bytes(build_pool(cfg, 1, page_size, policy, device="meta"))


def attention_bytes_per_position(pool: Dict[str, torch.Tensor]
                                 ) -> Dict[str, int]:
    """``per_pos``: bytes one live cache position costs a decode step's
    attention read (K + V over every layer, in the pool's dtype);
    ``widest``: K + V bytes of one position in one layer."""
    n, _, _, hkv, d = pool["k"].shape
    one = 2 * hkv * d * pool["k"].element_size()
    return {"per_pos": n * one, "widest": one}


def pool_scale_map(pool: Dict[str, torch.Tensor]
                   ) -> Optional[Dict[str, np.ndarray]]:
    """Flat host copies ``{"k_scale": ..., "v_scale": ...}`` of an int8
    pool's scales, or None for an unquantized pool."""
    out = {key: pool[key].detach().cpu().numpy().ravel().copy()
           for key in ("k_scale", "v_scale") if key in pool}
    return out or None


def attention_memory_est(pool: Dict[str, torch.Tensor], max_slots: int,
                         max_pages_per_slot: int, page_size: int,
                         impl: str = "stream") -> Dict:
    """Worst-case decode-attention memory (every slot at
    ``max_pages_per_slot * page_size`` positions), as ``repro`` counts it:
    ``attention_bytes_per_token`` (bytes attention touches to emit one
    token for one slot, over every layer; the gather path also writes and
    re-reads the gathered view, 3x) and ``peak_attention_bytes`` (the
    largest transient buffer of one step: the gathered k + v views of one
    layer, or one ``BLOCK_PAGES``-page chunk per slot when streaming).
    Scale reads are left out, as in ``repro``."""
    from ..kernels.paged_attention import BLOCK_PAGES
    terms = attention_bytes_per_position(pool)
    per_pos, widest = terms["per_pos"], terms["widest"]
    max_len = max_pages_per_slot * page_size
    if impl == "gather":
        return {"attention_bytes_per_token": 3 * per_pos * max_len,
                "peak_attention_bytes": max_slots * max_len * widest}
    chunk = min(BLOCK_PAGES, max_pages_per_slot) * page_size
    return {"attention_bytes_per_token": per_pos * max_len,
            "peak_attention_bytes": max_slots * chunk * widest}
