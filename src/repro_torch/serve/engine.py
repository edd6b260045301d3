"""Continuous-batching engine over the paged KV pool (port of
``repro/serve/engine.py:ContinuousEngine``).

* KV state lives in a paged pool (``serve/kvcache.py``); pages go back to
  the free list the moment a request retires.
* The scheduler (``serve/scheduler.py``) admits queued requests into free
  decode slots between decode dispatches; admitted requests prefill at
  B=1, right-padded to a page bucket, and their KV is scattered into pages.
* Decode runs ``decode_chunk`` steps per dispatch with every slot at its
  own position (``serve/decode.py``); finished slots freeze and retire
  between dispatches.  Optimistic admission preempts the youngest slot when
  the pool runs out, and the preempted request recomputes its prefill with
  the tokens it had generated, so greedy output is unchanged.

The engine bakes the spectral planes into ``params`` (in place) and runs on
the device the weights are on: the card by default, with its CUDA kernels.
``quant`` (a ``QuantPolicy``) picks the pool's dtype (f32, bf16 or int8
with per-(page, head) scales) and whether the planes are int8 / int4;
``paged_attn`` picks the decode attention: "stream" (the paged flash-decode
kernel) or "gather" (the parity oracle).

Not ported yet: the batch ``Engine``, sampling, request traces, the
numerics health plane and shadow oracle (with the quantization histograms
that ride it), fault injection and meshes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device, synchronize
from ..obs.metrics import Registry
from ..quant.codec import QuantPolicy
from . import decode as dec
from . import kvcache as kvc
from .params import precompute_serving_params
from .scheduler import (CANCELLED, FAILED, FINISHED_BUDGET, FINISHED_EOS,
                        REJECTED, TIMEOUT, Scheduler)

# Counters kept in the registry under the same names and units as
# ``repro``'s engines (``*_s`` counters accumulate seconds).
ENGINE_COUNTERS = ("requests", "tokens", "prompt_tokens",
                   "padded_prompt_tokens", "prefill_s", "decode_s",
                   "dispatches")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    id: int = 0
    # relative deadline (seconds after arrival; None = none), enforced in
    # the queue and in flight
    deadline_s: Optional[float] = None


class ContinuousEngine:
    """Continuous-batching engine: paged KV pool + token-budget scheduler.

    Every submitted request reaches exactly one terminal status.  Greedy
    outputs equal a B=1 run of each request, including across preemption.
    ``device`` defaults to the CUDA card; ``params`` must already be on it.
    ``decode_steps`` counts forward passes of the decode loop and
    ``prefills`` counts prefill calls (both also in ``stats()``).
    """

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_tokens_in_flight: Optional[int] = None,
                 decode_chunk: int = 8, sample: bool = False,
                 eos_id: Optional[int] = None,
                 precompute: bool = True, paged_attn: str = "stream",
                 quant: Optional[QuantPolicy] = None,
                 admission: str = "optimistic",
                 max_queue: Optional[int] = None,
                 max_preemptions: int = 4, nan_guard: bool = True,
                 registry: Optional[Registry] = None, device=None):
        if paged_attn not in ("stream", "gather"):
            raise ValueError(f"paged_attn {paged_attn!r}: "
                             f"expected 'stream' or 'gather'")
        reasons = kvc.servable_reasons(cfg)
        if reasons:
            raise ValueError(f"{cfg.name} is not continuous-servable: "
                             f"{'; '.join(reasons)}")
        want = resolve_device(device)
        on = {t.device for t in params.parameters()}
        if len(on) != 1 or not all(
                d.type == want.type and want.index in (None, d.index)
                for d in on):
            raise ValueError(f"params are on {sorted(map(str, on))}, the "
                             f"engine runs on {want}")
        self.device = on.pop()
        self.cfg = cfg
        self.quant = quant or QuantPolicy()
        self.paged_attn = paged_attn
        self.params = (precompute_serving_params(params, cfg, self.quant)
                       if precompute else params)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.decode_chunk = decode_chunk
        self.eos_id = eos_id
        self.nan_guard = nan_guard
        self.max_pages_per_slot = kvc.pages_for(max_seq, page_size)
        if num_pages is None:
            num_pages = max_slots * self.max_pages_per_slot + 1
        if num_pages < self.max_pages_per_slot + 1:
            raise ValueError(f"num_pages {num_pages} cannot hold one "
                             f"max_seq request (+trash page)")
        if max_tokens_in_flight is None:
            # the gather oracle pays an O(max_seq) gathered view per slot
            # and layer each step, so its default budget is halved, as in
            # repro
            ceiling = max_slots * (max_seq + 1)
            max_tokens_in_flight = (ceiling if paged_attn == "stream"
                                    else max(max_seq + 1, ceiling // 2))
        if max_tokens_in_flight < max_seq + 1:
            raise ValueError(f"max_tokens_in_flight {max_tokens_in_flight} "
                             f"cannot admit one max_seq request")
        self.num_pages = num_pages
        self.pool = kvc.build_pool(cfg, num_pages, page_size, self.quant,
                                   device=self.device)
        self.registry = registry if registry is not None else Registry()
        reg = self.registry
        self.block_table = kvc.BlockTable(
            kvc.PageAllocator(num_pages, registry=reg),
            max_slots, page_size, self.max_pages_per_slot)
        self.scheduler = Scheduler(self.block_table, max_seq=max_seq,
                                   max_tokens_in_flight=max_tokens_in_flight,
                                   registry=reg, admission=admission,
                                   max_queue=max_queue,
                                   max_preemptions=max_preemptions)
        self._loop = dec.make_paged_decode_loop(
            cfg, decode_chunk, sample=sample, eos_id=eos_id,
            nan_guard=nan_guard, paged_impl=paged_attn)
        self._prefills: Dict[int, object] = {}
        self._cur = np.zeros(max_slots, np.int32)
        self._pos = np.zeros(max_slots, np.int32)
        self._rem = np.zeros(max_slots, np.int32)
        self._dev_table = None              # device copy of the block table
        self._table_version = -1            # BlockTable.version it mirrors
        self._ctr = {n: reg.counter(n) for n in ENGINE_COUNTERS}
        self._c_anom = reg.counter("engine.anomalies")
        self._c_steps = reg.counter("engine.decode_steps")
        self._c_prefills = reg.counter("engine.prefills")
        # saturation census of the int8 pool's prefill page writes
        self._c_kv_clip = reg.counter("quant.clip.kv_clipped")
        self._c_kv_total = reg.counter("quant.clip.kv_total")
        self._t0_perf = None                # serve-clock origin (perf)
        self._results: Dict[int, Dict] = {}      # order -> terminal result
        self._cancels: set = set()          # request ids pending cancel
        self._stall_streak = 0              # consecutive all-stalled rounds
        self._stall_limit = 3               # then FAIL the youngest stalled

    # -- public lifecycle API ---------------------------------------------
    def _now(self) -> float:
        """Seconds on the serve clock (0 at the first submit)."""
        if self._t0_perf is None:
            self._t0_perf = time.perf_counter()
        return time.perf_counter() - self._t0_perf

    def submit(self, request: Request, arrival_s: float = 0.0, *,
               resume_tokens: Optional[Sequence[int]] = None,
               preemptions: int = 0) -> int:
        """Queue one request; returns its order (the key for results).  A
        rejected submission gets an immediate REJECTED result."""
        if len(request.prompt) > self.max_seq:
            raise ValueError(f"prompt length {len(request.prompt)} exceeds "
                             f"max_seq {self.max_seq}")
        resume = list(resume_tokens) if resume_tokens else []
        if len(request.prompt) + len(resume) > self.max_seq:
            raise ValueError(
                f"prompt + resume length {len(request.prompt) + len(resume)} "
                f"exceeds max_seq {self.max_seq}")
        self._now()
        order, accepted = self.scheduler.submit(request, arrival_s,
                                                resume_tokens=resume,
                                                preemptions=preemptions)
        if not accepted:
            self._finish_unserved(order, request, resume, REJECTED,
                                  preemptions=preemptions)
        return order

    def cancel(self, request_id) -> bool:
        """Cancel a request wherever it lives (queued: now; running: at the
        next step boundary).  False when unknown or already terminal."""
        found = self.scheduler.cancel(request_id)
        if found is None:
            return False
        kind, obj = found
        if kind == "queued":
            self._finish_unserved(obj.order, obj.request, obj.resume_tokens,
                                  CANCELLED, preemptions=obj.preemptions)
        else:
            self._cancels.add(request_id)
        return True

    def step(self) -> bool:
        """One scheduler round; True if anything happened."""
        now = self._now()
        return self._step(now, arrived_before=now)

    def drain(self) -> List[Dict]:
        """Stop admitting, shed fresh queued work as REJECTED, run in-flight
        requests to their end.  Returns what went terminal meanwhile."""
        before = set(self._results)
        self.scheduler.close_intake()
        for entry in self.scheduler.flush_queue():
            self._finish_unserved(entry.order, entry.request,
                                  entry.resume_tokens, REJECTED,
                                  preemptions=entry.preemptions)
        while not self.scheduler.idle:
            if not self._step(self._now()):
                raise RuntimeError("drain stall: in-flight work cannot "
                                   "make progress")
        return [self._results[o] for o in sorted(set(self._results) - before)]

    def result(self, order: int, pop: bool = False) -> Optional[Dict]:
        return (self._results.pop(order, None) if pop
                else self._results.get(order))

    # -- serving loop -----------------------------------------------------
    def generate(self, reqs: Sequence[Request],
                 arrival_times: Optional[Sequence[float]] = None
                 ) -> List[Dict]:
        for r in reqs:                      # validate before admitting any
            if len(r.prompt) > self.max_seq:
                raise ValueError(
                    f"prompt length {len(r.prompt)} exceeds max_seq "
                    f"{self.max_seq}")
        self._t0_perf = time.perf_counter()
        arr = ([0.0] * len(reqs) if arrival_times is None
               else [float(a) for a in arrival_times])
        orders = [self.submit(r, a) for r, a in zip(reqs, arr)]
        gate = arrival_times is not None
        while not self.scheduler.idle:
            now = self._now()
            if gate and not self.scheduler.running and self.scheduler.queue:
                next_arr = self.scheduler.queue[0].arrival_s
                if next_arr > now:
                    time.sleep(next_arr - now)
                    now = self._now()
            progress = self._step(now, arrived_before=now if gate else None)
            if (not progress and not self.scheduler.running
                    and self.scheduler.queue):
                if gate and self.scheduler.queue[0].arrival_s > self._now():
                    continue
                raise RuntimeError(
                    "scheduler stall: queued request cannot be admitted "
                    "into an idle engine (budget/pool too small)")
        return [self._results.pop(o) for o in orders]

    def _step(self, now_s: float,
              arrived_before: Optional[float] = None) -> bool:
        sched = self.scheduler
        progress = False
        for entry in sched.expire_queue(now_s):
            self._finish_unserved(entry.order, entry.request,
                                  entry.resume_tokens, TIMEOUT,
                                  preemptions=entry.preemptions)
            progress = True
        if self._cancels:
            for slot in list(sched.running):
                if slot.request.id in self._cancels:
                    self._finish(slot, CANCELLED)
                    progress = True
            self._cancels.clear()
        for slot in list(sched.running):
            if slot.deadline_s is not None and now_s > slot.deadline_s:
                self._finish(slot, TIMEOUT)
                progress = True
        admitted = sched.try_admit(now_s, arrived_before)
        for entry in sched.drain_doomed():
            self._finish_unserved(entry.order, entry.request,
                                  entry.resume_tokens, FAILED,
                                  preemptions=entry.preemptions)
            progress = True
        for slot in admitted:
            self._prefill_slot(slot)
            progress = True
        prep = sched.prepare_decode(self.decode_chunk)
        for idx, _ in prep.preempted:
            self._rem[idx] = 0              # victim's slot is dead on device
            progress = True
        if admitted or prep.preempted or prep.runnable:
            self._stall_streak = 0
        if prep.runnable:
            self._dispatch_decode(prep.runnable, prep.stalled)
            progress = True
        elif prep.stalled:
            # every live slot is starved and no victim remains: retry a
            # bounded number of rounds, then FAIL the youngest stalled slot
            self._stall_streak += 1
            progress = True
            if self._stall_streak >= self._stall_limit:
                victim = max(prep.stalled, key=lambda s: s.order)
                self._finish(victim, FAILED)
                self._stall_streak = 0
        return progress

    def _prefill_fn(self, n_pages: int):
        fn = self._prefills.get(n_pages)
        if fn is None:
            fn = dec.make_prefill_pack_step(self.cfg, n_pages, self.page_size)
            self._prefills[n_pages] = fn
        return fn

    def _prefill_slot(self, slot) -> None:
        t0 = time.perf_counter()
        req = slot.request
        # a resumed (preempted) request teacher-forces prompt + generated
        # tokens through prefill: greedy decode then continues identically
        prompt = list(np.asarray(req.prompt).tolist()) + list(slot.tokens)
        S = len(prompt)
        n_pages = kvc.pages_for(S, self.page_size)
        spad = n_pages * self.page_size
        toks = np.zeros(spad, np.int64)
        toks[:S] = prompt                              # right-pad
        batch = {"tokens": torch.as_tensor(toks[None], device=self.device)}
        pages = torch.as_tensor(self.block_table.pages(slot.index)[:n_pages],
                                dtype=torch.int64, device=self.device)
        with torch.no_grad():
            nxt, ok, self.pool, kv_clip = self._prefill_fn(n_pages)(
                self.params, batch, self.pool, pages, S)
            first, ok = int(nxt), bool(ok)
            if kv_clip is not None:            # one transfer for both
                clipped, total = torch.stack(kv_clip).tolist()
                self._c_kv_clip.inc(clipped)
                self._c_kv_total.inc(total)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self._ctr["prefill_s"].inc(dt)
        self._ctr["prompt_tokens"].inc(S)
        self._ctr["padded_prompt_tokens"].inc(spad)
        self._c_prefills.inc()
        slot.prefill_s = dt
        if self.nan_guard and not ok:
            # poisoned prefill: never stream a garbage first token
            self._c_anom.inc()
            self._rem[slot.index] = 0
            self._finish(slot, FAILED)
            return
        slot.tokens.append(first)
        slot.pos = S                       # position of the token in flight
        slot.budget -= 1
        self._cur[slot.index] = first
        self._pos[slot.index] = S
        self._rem[slot.index] = slot.budget
        self._ctr["tokens"].inc()          # the prefill-emitted token
        if (len(slot.tokens) >= slot.total_budget
                or (self.eos_id is not None and first == self.eos_id)):
            self._rem[slot.index] = 0
            self._finish(slot)
        elif slot.deadline_s is not None and self._now() > slot.deadline_s:
            self._rem[slot.index] = 0
            self._finish(slot, TIMEOUT)

    def _dispatch_decode(self, runnable, stalled) -> None:
        t0 = time.perf_counter()
        # stalled slots (no pages for the next chunk) are masked out of this
        # dispatch: rem=0 freezes them, their budget is restored afterwards
        rem_dispatch = self._rem.copy()
        for s in stalled:
            rem_dispatch[s.index] = 0
        if self._table_version != self.block_table.version:
            self._dev_table = self.block_table.device_table(self.device)
            self._table_version = self.block_table.version
        dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        with torch.no_grad():
            buf, cur, self.pool, pos, rem, done, anom, steps = self._loop(
                self.params, dev(self._cur), self.pool, self._dev_table,
                dev(self._pos), dev(rem_dispatch))
            buf, cur, pos, rem, done, anom = (
                t.cpu().numpy() for t in (buf, cur, pos, rem, done, anom))
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self._cur = cur.copy()
        self._pos = pos.copy()
        rem_after = rem.copy()
        saved = {s.index: self._rem[s.index] for s in stalled}
        self._rem = rem_after.copy()
        for idx, v in saved.items():
            self._rem[idx] = v
        self._ctr["decode_s"].inc(dt)
        self._ctr["dispatches"].inc()
        self._c_steps.inc(steps)
        for slot in runnable:
            b = slot.index
            n = int(rem_dispatch[b] - rem_after[b])
            if n:
                slot.tokens.extend(buf[b, :n].tolist())
                slot.pos = int(self._pos[b])
                self._ctr["tokens"].inc(n)
            if anom[b]:
                self._c_anom.inc()
                self._finish(slot, FAILED)
            elif done[b]:
                self._finish(slot)

    # -- terminal transitions ---------------------------------------------
    def _finish(self, slot, status: Optional[str] = None) -> None:
        """Retire a slot-resident request (``status`` None: EOS or budget)."""
        if status is None:
            toks = slot.tokens
            status = (FINISHED_EOS
                      if (self.eos_id is not None and toks
                          and toks[-1] == self.eos_id)
                      else FINISHED_BUDGET)
        now = self._now()
        prefill_s = getattr(slot, "prefill_s", 0.0)
        arrival, admit = slot.arrival_s, slot.admit_s
        self._rem[slot.index] = 0           # device slot is dead
        res = self.scheduler.retire(slot, status)  # releases the pages
        decode_s = max(now - admit - prefill_s, 0.0)
        res.update({
            "tokens_per_s": res["decode_len"] / max(decode_s, 1e-9),
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "queue_s": max(admit - arrival, 0.0),
            "latency_s": max(now - arrival, 0.0),
        })
        self._ctr["requests"].inc()
        self._results[res.pop("order")] = res

    def _finish_unserved(self, order: int, request, tokens, status: str,
                         preemptions: int = 0) -> None:
        """Terminal result for a request that never (re)entered a slot."""
        self._results[order] = {
            "id": request.id,
            "tokens": list(tokens),
            "decode_len": len(tokens),
            "status": status,
            "preemptions": preemptions,
            "tokens_per_s": 0.0,
            "prefill_s": None,
            "decode_s": 0.0,
            "queue_s": None,
            "latency_s": None,
        }

    # -- telemetry --------------------------------------------------------
    def stats(self) -> Dict:
        """Engine + scheduler counters (``repro``'s schema, where ported)."""
        v = self.registry.value
        st = {"engine": "continuous"}
        for name in ENGINE_COUNTERS:
            val = v(name)
            st[name] = val if name.endswith("_s") else int(val)
        st["prompt_pad_waste"] = (st["padded_prompt_tokens"]
                                  - st["prompt_tokens"])
        st["tokens_per_s"] = st["tokens"] / max(
            st["prefill_s"] + st["decode_s"], 1e-9)
        st["decode_dispatches"] = st["dispatches"]
        st.update(self.scheduler.stats())
        st["anomalies"] = int(v("engine.anomalies"))
        st["decode_steps"] = int(v("engine.decode_steps"))
        st["prefills"] = int(v("engine.prefills"))
        st["free_pages"] = int(v("pool.free_pages"))
        low = self.registry.gauge("pool.free_pages").min_seen
        st["min_free_pages"] = (int(low) if low is not None
                                else st["free_pages"])
        st["pages_alloc"] = int(v("pool.pages_alloc"))
        st["pages_freed"] = int(v("pool.pages_freed"))
        kv_total = v("quant.clip.kv_total")
        st["kv_clip_rate"] = (v("quant.clip.kv_clipped") / kv_total
                              if kv_total else None)
        st["pool_bytes"] = kvc.pool_bytes(self.pool)
        st["kv_pool_bytes"] = st["pool_bytes"]
        st["quant_policy"] = self.quant.describe()
        st["prefill_buckets"] = sorted(self._prefills)
        st["attention_impl"] = self.paged_attn
        st.update(kvc.attention_memory_est(
            self.pool, self.max_slots, self.max_pages_per_slot,
            self.page_size, self.paged_attn))
        st["decode_peak_bytes_est"] = (st["pool_bytes"]
                                       + st["peak_attention_bytes"])
        st["device"] = str(self.device)
        return st
