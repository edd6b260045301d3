"""Serving step builders (port of ``repro/serve/decode.py``): the batch
engine's prefill, single-token decode and multi-token decode loop over a
dense cache (whatever the model's cache holds: linear or ring KV,
recurrent state, an encoder-decoder's ``{"self", "cross"}``; the steps
pass it through), and the continuous engine's B=1 prefill-and-pack and
paged decode loop.

``repro`` runs each decode loop as one device program
(``lax.while_loop``).  Here the continuous engine's paged step runs over
static device buffers and, on a CUDA device, is captured once in a CUDA
graph: each step is one replay (``make_paged_decode_loop``).  The batch
engine's dense loop is a host loop, each step a forward pass of kernels on
the current stream.  Both keep ``repro``'s per-row freeze rules, and each
step reads one bit back to the host (whether every row is done), so the
loops, like ``repro``'s, end early; that read is their only sync.

Sampling draws ``categorical(logits / temperature)`` with Gumbel noise from
a counter-based hash in torch integer operations (``sample_tokens``): the
noise of a row depends only on the seed, the row's stream (batch row or
decode slot) and the position it decodes, never on call order or device.
So ``per_token`` equals ``scan`` and a recompute draws the same noise.  It
cannot reproduce ``jax.random``'s bits (ROADMAP C).

The numerics capture of ``repro`` (``capture_stats``: ``logit_stats``,
``cache_group_absmax``) feeds the health plane (``obs/health.py``): the
prefill-and-pack step returns one flat float32 vector of reductions, and
the paged step carries, in static buffers its CUDA graph writes, each
slot's latest finite logit row and an exact per-step non-finite count;
the reductions run once after the chunk, outside the graph.

Left out: logits sharding (one card).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..kernels import build
from ..layers.ffn import MoE
from ..models.registry import build_model
from . import kvcache as kvc


# dispatch-kind names: the profiler's attribution units (obs/prof.py), the
# keys of stats()["roofline"] and the Chrome trace's lanes
DECODE_CHUNK_KIND = "decode_chunk"


def prefill_kind(n_pages: int) -> str:
    """Continuous engine: one prefill kind per page bucket."""
    return f"prefill_{n_pages}p"


def batch_prefill_kind(batch: int, seq: int) -> str:
    """Batch engine: one prefill shape per (B, padded S)."""
    return f"prefill_b{batch}_s{seq}"


def batch_decode_kind(steps: int, batch: int) -> str:
    """Batch engine: one decode loop per (step budget, B)."""
    return f"decode_loop_s{steps}_b{batch}"


# ---------------------------------------------------------------------------
# sampling: Gumbel-max over a counter-based hash
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32), without overflowing
    int64: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seed: int, streams: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) float32 Gumbel noise; row b is keyed by
    ``(seed, streams[b], positions[b])`` and element v by its vocab index."""
    dev = streams.device
    h = _fmix32(torch.full_like(streams, seed & _M32, dtype=torch.int64))
    h = _fmix32(h ^ (streams.long() & _M32))
    h = _fmix32(h ^ (positions.long() & _M32))
    v = torch.arange(vocab, device=dev, dtype=torch.int64)
    bits = _fmix32(_fmix32(h[:, None] ^ v[None, :]) ^ (h[:, None] >> 1))
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))     # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temperature: float, seed: int,
                  streams: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """One categorical draw per row at ``logits / temperature`` (B, V):
    ``argmax(logits / T + Gumbel noise)``, the noise keyed as
    ``gumbel_noise`` says.  Returns (B,) int32."""
    g = gumbel_noise(seed, streams, positions, logits.shape[-1])
    return torch.argmax(logits.float() / temperature + g,
                        dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# batch engine: prefill, decode step, decode loop over a dense cache
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ArchConfig, *, kernel_fn=None) -> Callable:
    """``prefill_step(params, batch, cache)`` -> (last-position logits
    (B, 1, V), cache).  ``batch`` holds ``tokens`` and the stub
    frontend's ``patches`` or ``frames`` (``engine.py:frontend_inputs``).
    ``kernel_fn`` is the projections' spectral-MAC hook
    (the batch engine passes ``kernels/ops.py:spectral_contract``)."""
    model = build_model(cfg)

    def prefill_step(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache,
                                      kernel_fn=kernel_fn)
        return logits[:, -1:], cache
    return prefill_step


def make_decode_step(cfg: ArchConfig, sample: bool = False,
                     temperature: float = 1.0, seed: int = 0) -> Callable:
    """``decode_step(params, tokens (B, 1), cache, cache_pos int)`` ->
    (logits (B, 1, V), next tokens (B,) int32, cache).  Sampling keys row
    b's noise by (seed, b, cache_pos), as ``repro`` folds the position into
    its key; greedy takes the argmax."""
    model = build_model(cfg)

    def decode_step(params, tokens, cache, cache_pos: int):
        logits, cache = model.decode_step(params, tokens, cache,
                                          int(cache_pos))
        last = logits[:, -1]
        if sample:
            B = last.shape[0]
            rows = torch.arange(B, device=last.device)
            nxt = sample_tokens(last, temperature, seed, rows,
                                torch.full_like(rows, int(cache_pos)))
        else:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return logits, nxt, cache
    return decode_step


def make_decode_loop(cfg: ArchConfig, steps: int, *, sample: bool = False,
                     temperature: float = 1.0, eos_id: Optional[int] = None,
                     seed: int = 0) -> Callable:
    """Multi-token decode against a dense cache: up to ``steps`` tokens per
    row, the first being the prefill's.

    Per-row lengths are honored as in ``repro``: ``lengths[i]`` freezes row
    ``i`` after its budget (its buffer slots hold ``eos_id`` or 0 and its
    current token stops advancing); with ``eos_id`` set, a row also freezes
    after emitting EOS.  The loop exits early once every row is done.  A
    frozen row still runs through the step (the batch is one tensor); its
    output is discarded.

    Returns ``decode_loop(params, first_tok, cache, pos0, lengths)`` ->
    ``(tokens (B, steps) int32, cache, n)``; ``first_tok`` is the
    prefill's token (slot 0 of the buffer), ``pos0`` the prompt length and
    ``n`` the number of decode steps (forward passes) it ran.  Each step
    syncs once, to test whether every row is done.
    """
    step = make_decode_step(cfg, sample=sample, temperature=temperature,
                            seed=seed)
    fill = 0 if eos_id is None else int(eos_id)

    def decode_loop(params, first_tok, cache, pos0: int, lengths):
        B = first_tok.shape[0]
        fill_t = torch.full_like(first_tok, fill)
        buf = torch.full((B, steps), fill, dtype=torch.int32,
                         device=first_tok.device)
        buf[:, 0] = torch.where(lengths > 0, first_tok, fill_t)
        done = lengths <= 1
        if eos_id is not None:
            done = done | (first_tok == eos_id)
        cur = first_tok
        n = 0
        for j in range(1, steps):
            if bool(done.all()):
                break
            _, nxt, cache = step(params, cur[:, None], cache, pos0 + j - 1)
            buf[:, j] = torch.where(done, fill_t, nxt)
            nd = done | (j + 1 >= lengths)
            if eos_id is not None:
                nd = nd | (nxt == eos_id)
            cur = torch.where(done, cur, nxt)
            done = nd
            n += 1
        return buf, cache, n
    return decode_loop


# ---------------------------------------------------------------------------
# device-side numerics capture (obs/health.py)
# ---------------------------------------------------------------------------
def logit_stats(lg: torch.Tensor) -> torch.Tensor:
    """``(..., V)`` logits -> ``(..., 4)`` float32 health reductions:
    ``[absmax, softmax entropy, top1-top2 margin, non-finite count]``.

    Rows holding non-finite values give non-finite absmax / entropy /
    margin; consumers (``obs/health.py``) key on column 3 and skip the
    rest.  The top-2 margin masks exactly the argmax position and takes
    the max again (tied maxima: margin 0, as ``repro``'s)."""
    r = lg.float()
    nonf = (~torch.isfinite(r)).sum(-1).float()
    absmax = r.abs().amax(-1)
    m = r.amax(-1, keepdim=True)
    z = r - m
    lse = torch.log(torch.exp(z).sum(-1))
    p = torch.exp(z - lse[..., None])
    ent = lse - (p * z).sum(-1)
    idx = torch.argmax(r, dim=-1, keepdim=True)
    vocab = torch.arange(r.shape[-1], device=r.device)
    r2 = torch.where(vocab == idx, float("-inf"), r)
    margin = m[..., 0] - r2.amax(-1)
    return torch.stack([absmax, ent, margin, nonf], dim=-1)


def cache_group_absmax(cache) -> torch.Tensor:
    """Per-layer activation absmax over a layer-stacked dense cache
    ((L, B, S, Hkv, D) ``k`` and ``v``, the layout of every
    continuous-servable arch's prefill cache): the L layers' K absmax,
    then V's, ``repro``'s order for one segment.  The prefill cache is the
    one place every layer's activations are materialized, so the prefill
    carries this vector to ``health.act_absmax``."""
    return torch.cat([cache[key].float().abs().flatten(1).amax(1)
                      for key in ("k", "v")])


# ---------------------------------------------------------------------------
# continuous engine: B=1 prefill + page pack, paged decode loop
# ---------------------------------------------------------------------------
def make_prefill_pack_step(cfg: ArchConfig, n_pages: int, page_size: int,
                           capture_stats: bool = False) -> Callable:
    """B=1 exact-position prefill + page scatter, one call per admission.

    The prompt is right-padded to ``n_pages * page_size``; causal masking
    keeps positions < S exact, and the padded tail of the cache stays masked
    until decode overwrites it.  The dense prefill cache is float32 and is
    scattered into the pool's dtype.

    ``batch`` holds the padded ``tokens`` (1, spad) and, for a
    vision-stub config, ``patches``.  An int8 pool is packed with
    ``true_len`` (the pad tail zeroed before the page scales are derived).

    Returns ``prefill_pack(params, batch, pool, pages, true_len)`` ->
    ``(first_token, ok, pool, stats)``: the greedy token at the prompt's
    last true position and whether those logits are all finite (device
    scalars).  With ``capture_stats`` (the obs-enabled engine) ``stats`` is
    ONE flat float32 device vector ``[logit_stats(4) | kv_clipped |
    kv_total | act_absmax per layer group]`` (the int8 pool's saturation
    census of the values it wrote; zeros for other pools), so the host
    reads it back once a prefill; without, None.
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
        if not capture_stats:
            pool = kvc.pack_prefill_cache(pool, dense, pages, page_size,
                                          true_len=true_len)
            return nxt, ok, pool, None
        pool, clipped, total = kvc.pack_prefill_cache(
            pool, dense, pages, page_size, true_len=true_len,
            with_stats=True)
        stats = torch.cat([logit_stats(last), torch.stack([clipped, total]),
                           cache_group_absmax(dense)])
        return nxt, ok, pool, stats
    return prefill_pack


class DecodeSlots:
    """The static device buffers of the paged decode step: per slot the
    token in flight ``cur``, its position ``pos``, the budget left ``rem``,
    ``done`` and ``anom``; the output buffer ``buf`` (B, chunk); the
    column index ``j`` (a (1,) device tensor, as ``dynamic_update_slice``
    takes it); and the block ``table``.  With ``vocab`` (the numerics
    capture) also each slot's latest finite logit row ``lastrow`` (B,
    vocab) and its non-finite step count ``nonf`` (B,), float32.  Each step
    reads and writes them in place, so one captured CUDA graph replays
    every step.  ``graph`` and ``record`` (its launches,
    ``kernels/build.py``) are set where the step is captured."""

    def __init__(self, B: int, chunk: int, maxp: int, device, fill: int,
                 vocab: Optional[int] = None):
        i32 = dict(dtype=torch.int32, device=device)
        self.fill = fill
        self.cur = torch.zeros(B, **i32)
        self.pos = torch.zeros(B, **i32)
        self.rem = torch.zeros(B, **i32)
        self.done = torch.ones(B, dtype=torch.bool, device=device)
        self.anom = torch.zeros(B, dtype=torch.bool, device=device)
        self.buf = torch.full((B, chunk), fill, **i32)
        self.j = torch.zeros(1, dtype=torch.int64, device=device)
        self.table = torch.zeros((B, maxp), **i32)
        self.lastrow = self.nonf = None
        if vocab is not None:
            f32 = dict(dtype=torch.float32, device=device)
            self.lastrow = torch.zeros((B, vocab), **f32)
            self.nonf = torch.zeros(B, **f32)
        self.params = None          # the weights a captured graph reads
        self.graph = None
        self.record = None

    def stage(self, cur, pos, rem, table=None) -> None:
        """Copy one dispatch's inputs in (host or device tensors); the
        ``table`` only where it is not the static one already."""
        self.cur.copy_(cur)
        self.pos.copy_(pos)
        self.rem.copy_(rem)
        if table is not None and table is not self.table:
            self.table.copy_(table)
        torch.le(self.rem, 0, out=self.done)
        self.anom.zero_()
        self.buf.fill_(self.fill)
        self.j.zero_()
        if self.lastrow is not None:
            self.lastrow.zero_()
            self.nonf.zero_()

    def idle(self) -> None:
        """Every slot frozen at position -1: a step writes only to the
        trash page and changes no slot."""
        self.table.zero_()
        self.stage(torch.zeros_like(self.cur), torch.full_like(self.pos, -1),
                   torch.zeros_like(self.rem))


class PagedDecodeLoop:
    """``make_paged_decode_loop``'s loop: ``loop(params, cur, pool, table,
    pos, rem)`` runs up to ``chunk`` steps over the static buffers of
    ``slots(params, pool, B, maxp)`` and returns copies of them (its
    docstring).  ``captures`` and ``capture_s`` count the CUDA-graph
    captures made and their seconds (warm-up included)."""

    def __init__(self, cfg: ArchConfig, chunk: int, *, sample: bool,
                 temperature: float, eos_id: Optional[int], seed: int,
                 nan_guard: bool, paged_impl: str, graphs: Optional[bool],
                 capture_stats: bool = False):
        self.model = build_model(cfg)
        self.capture_stats = capture_stats
        self.last_stats = None              # (B, 4) of the last call
        self.chunk = chunk
        self.sample, self.temperature, self.seed = sample, temperature, seed
        self.eos_id, self.nan_guard = eos_id, nan_guard
        self.paged_impl = paged_impl
        self.graphs = graphs
        self.fill = 0 if eos_id is None else int(eos_id)
        self._key, self._slots = None, None
        self.captures = 0
        self.capture_s = 0.0

    def step(self, params, st: DecodeSlots, pool) -> None:
        """One decode step over ``st``, in place (``repro``'s ``body_fn``):
        a frozen slot decodes at position -1 (its writes go to the trash
        page) and keeps its state; a slot whose logits are not all finite
        (``nan_guard``) freezes like an EOS slot, appends ``fill`` and is
        flagged in ``anom``; the token lands in column ``j`` of ``buf``.
        No value is read back to the host."""
        done = st.done
        masked = torch.where(done, -1, st.pos)
        logits, _ = self.model.decode_step(params, st.cur[:, None], pool,
                                           masked, block_table=st.table,
                                           paged_impl=self.paged_impl)
        last = logits[:, -1]
        finite = (torch.isfinite(last).all(dim=-1) if self.nan_guard
                  else torch.ones_like(done))
        if self.sample:
            slots = torch.arange(done.shape[0], device=done.device)
            nxt = sample_tokens(last, self.temperature, self.seed, slots,
                                torch.clamp(masked, min=0))
        else:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        bad = ~done & ~finite
        halt = done | bad
        st.buf.index_copy_(1, st.j, torch.where(halt, st.fill, nxt)[:, None])
        st.pos.copy_(torch.where(halt, st.pos, st.pos + 1))
        st.rem.copy_(torch.where(halt, st.rem, st.rem - 1))
        nd = halt | (st.rem <= 0)
        if self.eos_id is not None:
            nd = nd | (~halt & (nxt == self.eos_id))
        st.cur.copy_(torch.where(halt, st.cur, nxt))
        st.done.copy_(nd)
        st.anom.logical_or_(bad)
        st.j.add_(1)
        if st.lastrow is not None:
            # the latest FINITE active row per slot (a poisoned row never
            # lands in the sample); ``bad`` counts every non-finite step
            upd = (~halt & finite)[:, None]
            st.lastrow.copy_(torch.where(upd, last.float(), st.lastrow))
            st.nonf.add_(bad.float())

    def slots(self, params, pool, B: int, maxp: int) -> DecodeSlots:
        """The static buffers for ``B`` slots of ``maxp``-page tables over
        ``pool`` with ``params``, made (and, on a CUDA device with
        ``graphs`` not False, the step captured) when any of these differ
        from the last call's.  The graph holds the addresses of ``pool``
        and of the weights: the key has the pool's, and the buffers keep
        ``params`` alive."""
        device = pool["k"].device
        key = (id(params), B, maxp, pool["k"].dtype,
               tuple(t.data_ptr() for t in pool.values()),
               self.capture_stats)
        if key != self._key:
            self._key, self._slots = None, None    # free the old graph
            vocab = (params.embed.table.shape[0] if self.capture_stats
                     else None)
            st = DecodeSlots(B, self.chunk, maxp, device, self.fill, vocab)
            st.params = params
            capture = (self.graphs if self.graphs is not None
                       else device.type == "cuda")
            if capture:
                self._capture(params, pool, st)
            self._key, self._slots = key, st
        return self._slots

    def _capture(self, params, pool, st: DecodeSlots) -> None:
        """Warm the step up twice on idle slots (a side stream; the second
        time with synchronizing calls made errors), then capture it.  The
        launches of both count apart (``kernels/build.py:setup``); an MoE's
        running router gap is restored after the warm-up.  A capture that
        fails raises."""
        if st.cur.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the pool "
                             f"is on {st.cur.device}")
        t0 = time.perf_counter()
        device = st.cur.device
        gaps = [(m, m.logit_gap.clone()) for m in params.modules()
                if isinstance(m, MoE) and m.logit_gap is not None]
        st.idle()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        mode = torch.cuda.get_sync_debug_mode()
        graph, record = torch.cuda.CUDAGraph(), build.LaunchRecord()
        try:
            with torch.cuda.stream(side), build.setup():
                self.step(params, st, pool)   # libraries, cached constants
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.step(params, st, pool)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.current_stream(device).wait_stream(side)
            for m, gap in gaps:
                m.logit_gap.copy_(gap)
            with build.setup(record), torch.cuda.graph(graph):
                self.step(params, st, pool)
        except Exception as e:
            raise RuntimeError(f"capturing the paged decode step failed: "
                               f"{e}") from e
        torch.cuda.synchronize(device)
        st.graph, st.record = graph, record
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def __call__(self, params, cur, pool, table, pos, rem):
        B, maxp = table.shape
        st = self.slots(params, pool, B, maxp)
        st.stage(cur, pos, rem, table)
        steps = 0
        while steps < self.chunk and not bool(st.done.all()):
            if st.graph is not None:
                st.graph.replay()
                st.record.replayed()
            else:
                self.step(params, st, pool)
            steps += 1
        if st.lastrow is not None:
            stats = logit_stats(st.lastrow)
            stats[:, 3] = st.nonf
            self.last_stats = stats
        return (st.buf.clone(), st.cur.clone(), pool, st.pos.clone(),
                st.rem.clone(), st.done.clone(), st.anom.clone(), steps)


def make_paged_decode_loop(cfg: ArchConfig, chunk: int, *,
                           sample: bool = False, temperature: float = 1.0,
                           eos_id: Optional[int] = None, seed: int = 0,
                           nan_guard: bool = True,
                           paged_impl: str = "stream",
                           graphs: Optional[bool] = None,
                           capture_stats: bool = False) -> PagedDecodeLoop:
    """Decode over paged slots, up to ``chunk`` steps per call.

    ``paged_impl`` picks the attention lowering of each step: "stream"
    (the paged flash-decode kernel) or "gather" (the parity oracle: gather
    each slot's pages, then a masked softmax).

    Every slot advances at its own position.  A slot freezes when its budget
    reaches zero or it emits ``eos_id``; a frozen slot's writes go to the
    trash page (position -1) and its buffer entries hold ``eos_id`` (or 0).
    With ``nan_guard`` a slot whose logits are not all finite freezes like
    an EOS slot, appends nothing, and is flagged in ``anom``.  The loop
    stops early once every slot is frozen.  With ``sample`` each slot draws
    with noise keyed by (seed, slot, position), as ``repro`` folds both
    into its key.

    The step is ``repro``'s ``body_fn`` over static device buffers
    (``DecodeSlots``).  On a CUDA device it is captured in a CUDA graph once
    per (slots, table width, pool, weights) and every step is one replay;
    ``graphs=False`` runs the same step eagerly (on the CPU it always
    does).  Each step the host reads whether every slot is done, the loop's
    one sync, so early exit and ``steps`` equal ``repro``'s
    ``while_loop``.

    Returns a ``PagedDecodeLoop``: ``loop(params, cur, pool, table, pos,
    rem)`` -> ``(buf (B, chunk), cur, pool, pos, rem, done, anom,
    steps)``; ``steps`` is the number of decode steps (forward passes) it
    ran; ``cur``, ``pos``, ``rem`` and ``table`` may be host or device
    tensors.

    With ``capture_stats`` the loop's ``last_stats`` holds, after each
    call, a (B, 4) float32 device tensor per slot: ``[logit absmax,
    entropy, top1-margin, non-finite step count]`` (``logit_stats``
    columns).  Columns 0-2 are taken once a call from each slot's latest
    finite-step logit row, carried in ``DecodeSlots.lastrow`` (a masked
    row copy a step) and reduced after the chunk, outside the graph;
    column 3 counts the NaN guard's ``bad`` steps exactly, so ``anom`` is
    its thresholded view.  A slot that took no finite step keeps an
    all-zero row (margin 0 after reduction): the engine skips rows that
    took no step.  Without it ``last_stats`` stays None and the step is
    the one without capture.
    """
    return PagedDecodeLoop(cfg, chunk, sample=sample,
                           temperature=temperature, eos_id=eos_id, seed=seed,
                           nan_guard=nan_guard, paged_impl=paged_impl,
                           graphs=graphs, capture_stats=capture_stats)
