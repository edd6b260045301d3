"""Serving engines (port of ``repro/serve/engine.py``): the
batch-synchronous ``Engine`` (the B=1 oracle) and the continuous-batching
``ContinuousEngine`` over the paged KV pool.

``Engine`` gathers fixed-size batches of requests, left-pads their prompts,
prefills each batch once and decodes it against a float32 dense cache
(``serve/decode.py``).  Under a single-admission schedule (one request,
B=1) its greedy tokens define what ``ContinuousEngine`` must emit.  Prompt
bucketing sorts requests by (prompt length, decode budget) before chunking
them into batches; results come back in request order.  Its prefill runs
every float32-plane projection's spectral MAC through the
``spectral_matmul`` kernel (the ``kernel_fn`` hook,
``kernels/ops.py:spectral_contract``): many rows share one set of planes
there.  The hook decides projection by projection (``PrefillContract``):
planes that kernel's block cannot stage (block sizes below about 32 at
tinyllama's widths) take the fused kernel, and ``stats()["prefill_lanes"]``
says which shapes took which.  Its decode passes no hook, so the B rows
take the fused kernel.

``ContinuousEngine``:

* KV state lives in a paged pool (``serve/kvcache.py``); pages go back to
  the free list the moment a request retires.
* The scheduler (``serve/scheduler.py``) admits queued requests into free
  decode slots between decode dispatches; admitted requests prefill at
  B=1, right-padded to a page bucket, and their KV is scattered into pages.
* Decode runs ``decode_chunk`` steps per dispatch with every slot at its
  own position (``serve/decode.py``); finished slots freeze and retire
  between dispatches.  On the card the decode step is captured in a CUDA
  graph when the engine is built (on idle slots) and each step is one
  replay; the block table is copied into the step's static table when it
  changes.  Optimistic admission preempts the youngest slot when
  the pool runs out, and the preempted request recomputes its prefill with
  the tokens it had generated, so greedy output is unchanged.

Both engines bake the spectral planes into ``params`` (in place) and run
on the device the weights are on: the card by default, with its CUDA
kernels.  ``quant`` (a ``QuantPolicy``) picks whether the planes are
int8 / int4 and, for ``ContinuousEngine``, the pool's dtype (f32, bf16 or
int8 with per-(page, head) scales); ``paged_attn`` picks its decode
attention: "stream" (the paged flash-decode kernel) or "gather" (the parity
oracle).  Both sample with ``sample=True`` at ``temperature`` from
``seed`` (``serve/decode.py:sample_tokens``).

Both take ``obs`` (``repro_torch.obs.Obs``; a fresh one by default), as
``repro``'s do: its registry backs ``stats()``, and with ``obs.enabled``
each request gets a trace, each dispatch a profiler span priced against
the card's ``HardwareSpec`` (``stats()["roofline"]``), and the continuous
engine folds the numerics capture of its prefill and decode steps into the
health plane (``obs/health.py``), with the int8 pool's and planes'
quantization telemetry and, with ``shadow_sample``, the shadow oracle.
Spans end at the host reads each dispatch already makes (the prefill's
token, the decode loop's ``done`` and outputs): obs adds no
synchronisation inside the replayed step.

``ContinuousEngine(faults=)`` takes a ``serve/faults.py:FaultInjector``:
its allocator hook fails page allocations, and before each decode dispatch
the engine sleeps for an injected delay and may NaN-poison a running
slot's first page.  The poison is written in place into the pool tensors
the captured decode step reads, so the step is never captured again.

Both take ``mesh`` (a ``DeviceMesh``; by default ``launch/mesh.py:
make_host_mesh()``, this host's (1, 1) ("data", "model") mesh on the
engine's device) and serve inside its activation policy
(``dist/ctx.py``), where ``repro``'s do; ``ContinuousEngine`` rounds its
page count up to the mesh's data-parallel size (``dist/sharding.py:
dp_round_up``).  On one card every placement is local: the policy's pins
pass plain tensors through.

``Engine(cache_dtype=)`` picks its dense cache's dtype: float32 by default
(the oracle, as ``repro``'s batch engine keeps it), or a config's
``kv_cache_dtype`` such as ``torch.float8_e4m3fn``: K/V are written
rounded as ``repro``'s ``astype`` rounds them and read by the float32
flash kernels' e4m3 lane (``layers/attention.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device, synchronize
from ..dist import ctx as dist_ctx
from ..dist import sharding as dist_sharding
from ..kernels import ops as kops
from ..kernels import spectral_matmul as smm
from ..launch import mesh as mesh_lib
from ..models.registry import build_model
from ..models.transformer import cache_bytes, layer_kinds, window_for
from ..obs import BYTES_BUCKETS, RATIO_BUCKETS, Obs
from ..obs.health import SCALE_BUCKETS, HealthPlane, ShadowOracle
from ..quant.codec import QuantPolicy, baked_caches, plane_clip_report
from ..roofline.analysis import ServingCounts
from . import decode as dec
from . import kvcache as kvc
from .faults import poison_slot_pages
from .params import precompute_serving_params
from .scheduler import (CANCELLED, FAILED, FINISHED_BUDGET, FINISHED_EOS,
                        REJECTED, TIMEOUT, Scheduler)

# Counters kept in the registry under the same names and units as
# ``repro``'s engines (``*_s`` counters accumulate seconds).
ENGINE_COUNTERS = ("requests", "tokens", "prompt_tokens",
                   "padded_prompt_tokens", "prefill_s", "decode_s",
                   "dispatches")


def _engine_stats_view(obs: Obs, engine: str) -> Dict:
    """The half of ``stats()`` both engines share (``repro``'s
    ``_engine_stats_view``): the counters, pad waste, tokens/s over
    prefill plus decode time, and the profiler's hardware and per-kind
    roofline summary."""
    v = obs.registry.value
    st = {"engine": engine}
    for name in ENGINE_COUNTERS:
        val = v(name)
        st[name] = val if name.endswith("_s") else int(val)
    st["prompt_pad_waste"] = (st["padded_prompt_tokens"]
                              - st["prompt_tokens"])
    st["tokens_per_s"] = st["tokens"] / max(
        st["prefill_s"] + st["decode_s"], 1e-9)
    st["hardware"] = obs.profiler.spec.name
    st["roofline"] = obs.profiler.summary()
    return st


def _dense_kv_bytes(cfg: ArchConfig, dtype=torch.float32) -> int:
    """Bytes of one position of one layer's K and V in the dense cache."""
    a = cfg.attention
    return 2 * a.num_kv_heads * a.head_dim * dtype.itemsize


def _engine_device(params, device) -> torch.device:
    """The device the weights are on, which must be ``device`` (default:
    the card)."""
    want = resolve_device(device)
    on = {t.device for t in params.parameters()}
    if len(on) != 1 or not all(
            d.type == want.type and want.index in (None, d.index)
            for d in on):
        raise ValueError(f"params are on {sorted(map(str, on))}, the "
                         f"engine runs on {want}")
    return on.pop()


def frontend_inputs(cfg: ArchConfig, batch: int, device) -> Dict:
    """The stub frontend's inputs a prefill batch carries, as ``repro``'s
    engines feed them, float32 zeros: ``frames`` (batch, encoder_seq,
    d_model) for an ``audio_stub`` config, ``patches`` (batch,
    num_patches, d_model) for a ``vision_stub`` one, nothing otherwise."""
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.frontend == "audio_stub":
        return {"frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      **f32)}
    if cfg.frontend == "vision_stub":
        return {"patches": torch.zeros((batch, cfg.num_patches, cfg.d_model),
                                       **f32)}
    return {}


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    id: int = 0
    # relative deadline (seconds after arrival; None = none), enforced in
    # the continuous engine's queue and in flight; the batch engine ignores
    # it (its whole batch is one dispatch)
    deadline_s: Optional[float] = None
    # shedding priority (``fleet/router.py``): lower sheds first when the
    # fleet's pending buffer overflows; the engines ignore it
    priority: int = 0


class PrefillContract:
    """The batch prefill's ``kernel_fn``: the spectral MAC of a projection's
    float32 planes through ``spectral_matmul``
    (``kernels/ops.py:spectral_contract``) where that kernel plans their
    (p, q, kf) shape, else (``takes`` is False) through the fused kernel,
    as ``core/circulant.py:_spectral_linear`` reads it.  Its block stages
    a bin chunk's three (q, p) planes whole, so at tinyllama's widths it
    takes block sizes from about 32 up.  The choice is made once a shape,
    at the first call (or up front for the baked caches of ``params``),
    and kept with the planner's reason.  Planes without the Gauss
    combinations (``gauss_trick=False``) always take the fused kernel's
    4-product lane: ``spectral_matmul`` contracts the Gauss planes only."""

    def __init__(self, params=None):
        self.lanes: Dict[tuple, str] = {}
        self.reasons: Dict[tuple, str] = {}
        if params is not None:
            for _, _, _, cache in baked_caches(params):
                if "wr_s" not in cache and cache["wr"].dim() == 3:
                    self.takes(cache)

    def takes(self, cache: Dict[str, torch.Tensor]) -> bool:
        shape = tuple(cache["wr"].shape)
        lane = self.lanes.get(shape)
        if lane is None and "ws1" not in cache:
            lane = "bc_fused"          # its 4-product lane (kernels/ops.py)
            self.reasons[shape] = ("planes without ws1 / ws2 "
                                   "(gauss_trick=False): spectral_matmul's "
                                   "contraction is the Gauss MAC only")
            self.lanes[shape] = lane
        if lane is None:
            p, q, kf = shape
            try:
                smm.plan(kf, 1, q, p, smm.BIN_MINOR)
                lane = "spectral_matmul"
            except ValueError as e:
                lane = "bc_fused"
                self.reasons[shape] = str(e)
            self.lanes[shape] = lane
        return lane == "spectral_matmul"

    def __call__(self, xr, xi, cache):
        return kops.spectral_contract(xr, xi, cache)

    def report(self) -> Dict[str, List[str]]:
        """The (p, q, kf) plane shapes each lane took, as "p x q x kf"."""
        out: Dict[str, List[str]] = {"spectral_matmul": [], "bc_fused": []}
        for shape, lane in sorted(self.lanes.items()):
            out[lane].append("x".join(map(str, shape)))
        return out


class Engine:
    """Batch-synchronous engine over a float32 dense cache: the oracle.

    ``decode_mode`` is "scan" (``make_decode_loop``: per-row lengths, EOS
    freeze, early exit) or "per_token" (one ``make_decode_step`` call per
    token, no freezing; the results are cut the same way).  Only the
    weight half of ``quant`` applies: the cache is float32, or
    ``cache_dtype`` (module docstring).  It serves
    every block kind: the ``attn`` / ``moe`` decoder LMs, the
    sliding-window ``attn_local`` (gemma2, recurrentgemma) and ``moe_swa``
    (mixtral) blocks over a ring cache (a batch's padded prompt must cover
    ``min(window, S + steps - 1)`` positions for the largest window, else
    ``ValueError``, as in ``repro``), recurrentgemma's ``rec`` and xlstm's
    ``mlstm`` / ``slstm`` blocks (recurrent state) and the encoder-decoder
    whisper (zero ``frames``; the cache holds the cross K/V).
    ``stats()`` adds ``prefills`` and ``decode_steps`` (forward passes) to
    the shared counters, ``cache_bytes`` (the largest cache it allocated:
    KV, ring, cross K/V and recurrent state) and ``dispatch_kinds`` (the
    prefill and decode-loop shapes it served).  With ``obs.enabled`` every
    request is traced (enqueue at ``generate``, admit at its batch's
    start, first token after the prefill, retire after the decode) and the
    prefill and the decode loop (not ``per_token``'s steps) are profiled.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256, sample: bool = False,
                 precompute: bool = True, decode_mode: str = "scan",
                 eos_id: Optional[int] = None, temperature: float = 1.0,
                 seed: int = 0, bucket_prompts: bool = True,
                 quant: Optional[QuantPolicy] = None,
                 obs: Optional[Obs] = None, device=None, mesh=None,
                 cache_dtype: torch.dtype = torch.float32):
        if decode_mode not in ("scan", "per_token"):
            raise ValueError(f"decode_mode {decode_mode!r}: expected 'scan' "
                             f"or 'per_token'")
        kinds = (set() if cfg.is_encoder_decoder
                 else set(layer_kinds(cfg)))
        # the largest sliding window of any block: its ring's prefill keeps
        # the window's tail, so a batch's prompts must cover it
        self._swa_window = max((window_for(k, cfg) for k in kinds),
                               default=0)
        self.device = _engine_device(params, device)
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.make_host_mesh(self.device))
        self.cfg = cfg
        self.cache_dtype = cache_dtype
        self.quant = quant or QuantPolicy()
        # the dense cache is float32 (the parity oracle) unless asked;
        # only the weight half of the policy applies here
        self.params = (precompute_serving_params(params, cfg, self.quant)
                       if precompute else params)
        self.model = build_model(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.sample = sample
        self.decode_mode = decode_mode
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.bucket_prompts = bucket_prompts
        self._contract = PrefillContract(self.params)
        self._prefill = dec.make_prefill_step(cfg, kernel_fn=self._contract)
        self._decode = dec.make_decode_step(cfg, sample=sample,
                                            temperature=temperature,
                                            seed=seed)
        self._loops: Dict[int, object] = {}
        # telemetry: the registry IS the stats() backing store; counters
        # are held directly so the hot path is one float add
        self.obs = obs if obs is not None else Obs()
        self.obs.profiler.bind_device(self.device)
        reg = self.obs.registry
        self._ctr = {n: reg.counter(n) for n in ENGINE_COUNTERS}
        self._c_steps = reg.counter("engine.decode_steps")
        self._c_prefills = reg.counter("engine.prefills")
        self._h_prefill = reg.histogram("engine.prefill_dispatch_s")
        self._h_decode = reg.histogram("engine.decode_dispatch_s")
        self._counts = ServingCounts(self.params, cfg,
                                     _dense_kv_bytes(cfg, cache_dtype))
        self._order = 0                     # trace submission order
        self._cache_bytes = 0               # largest dense cache so far
        self._kinds: set = set()            # prefill / decode shapes served

    def _loop_fn(self, steps: int):
        fn = self._loops.get(steps)
        if fn is None:
            fn = dec.make_decode_loop(self.cfg, steps, sample=self.sample,
                                      temperature=self.temperature,
                                      eos_id=self.eos_id, seed=self.seed)
            self._loops[steps] = fn
        return fn

    def _make_batch(self, reqs: Sequence[Request]) -> Dict:
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt     # left-pad
        return {"tokens": torch.as_tensor(toks, device=self.device),
                **frontend_inputs(self.cfg, B, self.device)}

    def generate(self, reqs: Sequence[Request]) -> List[Dict]:
        """Serve the requests; results in request order.  With
        ``bucket_prompts`` the requests are grouped into batches by
        (prompt length, decode budget) first."""
        if self.bucket_prompts:
            order = sorted(range(len(reqs)),
                           key=lambda i: (len(reqs[i].prompt),
                                          reqs[i].max_new_tokens))
        else:
            order = list(range(len(reqs)))
        # every request enqueues now; a later batch's traces carry the
        # queue wait its bucket imposed (admit - enqueue)
        t_enq = self.obs.now()
        traces = [None] * len(reqs)
        if self.obs.enabled:
            for i, r in enumerate(reqs):
                traces[i] = self.obs.trace_start(r.id, self._order,
                                                 len(r.prompt), t_enq)
                self._order += 1
        out: List[Optional[Dict]] = [None] * len(reqs)
        for i in range(0, len(order), self.max_batch):
            idxs = order[i:i + self.max_batch]
            for j, r in zip(idxs, self._generate_batch(
                    [reqs[j] for j in idxs], [traces[j] for j in idxs])):
                out[j] = r
        return out

    def _generate_batch(self, reqs: Sequence[Request],
                        traces: Sequence) -> List[Dict]:
        with dist_ctx.activation_policy(self.mesh):
            return self._generate_batch_inner(reqs, traces)

    def _generate_batch_inner(self, reqs: Sequence[Request],
                              traces: Sequence) -> List[Dict]:
        t0 = time.perf_counter()
        batch = self._make_batch(reqs)
        B, S = batch["tokens"].shape
        if S > self.max_seq:
            raise ValueError(f"prompt length {S} exceeds max_seq "
                             f"{self.max_seq}")
        # decode step j writes cache position S + j - 1 (j = 1..steps-1):
        # the cache holds S + steps - 1 positions and the budget is clamped
        steps = max(r.max_new_tokens for r in reqs)
        steps = max(1, min(steps, self.max_seq - S + 1))
        need = min(self._swa_window, S + steps - 1)
        if self._swa_window and S < need:
            raise ValueError(
                f"batch prompt length {S} does not cover the sliding-window "
                f"ring buffer ({need}): SWA prefill keeps the window tail, "
                f"so prompts must be >= min(window, cache length)")
        with torch.no_grad():
            cache = self.model.init_cache(B, S + steps - 1,
                                          dtype=self.cache_dtype,
                                          device=self.device)
            self._cache_bytes = max(self._cache_bytes, cache_bytes(cache))
            self._kinds.add(dec.batch_prefill_kind(B, S))
            logits, cache = self._prefill(self.params, batch, cache)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            synchronize(self.device)
            t1 = time.perf_counter()
            if self.decode_mode == "per_token":
                gen, n = self._decode_per_token(nxt, cache, S, steps)
            else:
                lengths = torch.as_tensor(
                    [min(r.max_new_tokens, steps) for r in reqs],
                    dtype=torch.int32, device=self.device)
                self._kinds.add(dec.batch_decode_kind(steps, B))
                gen, _, n = self._loop_fn(steps)(self.params, nxt, cache, S,
                                                 lengths)
            gen = gen.cpu().numpy()                    # (B, steps)
        synchronize(self.device)
        t2 = time.perf_counter()
        prefill_s, decode_s = t1 - t0, t2 - t1

        out = []
        for i, r in enumerate(reqs):
            toks = gen[i, :min(r.max_new_tokens, steps)].tolist()
            if self.eos_id is not None and self.eos_id in toks:
                toks = toks[:toks.index(self.eos_id) + 1]
            status = (FINISHED_EOS if (self.eos_id is not None and toks
                                       and toks[-1] == self.eos_id)
                      else FINISHED_BUDGET)
            out.append({
                "id": r.id,
                "tokens": toks,
                "decode_len": len(toks),
                "status": status,
                "preemptions": 0,
                "tokens_per_s": len(toks) / max(decode_s, 1e-9),
                "prefill_s": prefill_s,
                "decode_s": decode_s,
                "latency_s": prefill_s + decode_s,
            })
        c = self._ctr
        c["requests"].inc(len(reqs))
        c["dispatches"].inc()
        c["tokens"].inc(sum(r["decode_len"] for r in out))
        c["prompt_tokens"].inc(sum(len(r.prompt) for r in reqs))
        c["padded_prompt_tokens"].inc(B * S)
        c["prefill_s"].inc(prefill_s)
        c["decode_s"].inc(decode_s)
        self._c_prefills.inc()
        self._c_steps.inc(n)
        if self.obs.enabled:
            self._observe_batch(reqs, traces, out, (B, S, steps, n),
                                (t0, t1, t2))
        self.obs.tick()
        return out

    def _observe_batch(self, reqs, traces, out, shape, marks) -> None:
        """A batch's profiler spans (its prefill, and the decode loop in
        ``scan`` mode), histograms and traces."""
        B, S, steps, n = shape
        t0, t1, t2 = marks
        obs, prof = self.obs, self.obs.profiler
        lens = [len(r.prompt) for r in reqs]
        flops, nbytes = self._counts.prefill(lens)
        cost = prof.register(dec.batch_prefill_kind(B, S), flops, nbytes)
        prof.on_dispatch(cost, obs.rebase(t0), obs.rebase(t1))
        if self.decode_mode == "scan" and n:
            # row i decodes its tokens 2.. at positions S_i .. (keys S_i+1..)
            ctx = [s + j for s, res in zip(lens, out)
                   for j in range(1, res["decode_len"])]
            flops, nbytes = self._counts.decode(ctx, n, B)
            cost = prof.register(dec.batch_decode_kind(steps, B), flops,
                                 nbytes)
            prof.on_dispatch(cost, obs.rebase(t1), obs.rebase(t2))
        self._h_prefill.observe(t1 - t0)
        self._h_decode.observe(t2 - t1)
        for tr, res in zip(traces, out):
            if tr is None:
                continue
            tr.status = res["status"]
            tr.mark_admit(obs.rebase(t0))
            tr.mark_first_token(obs.rebase(t1))
            if res["decode_len"] > 1:
                tr.mark_chunk(obs.rebase(t2), res["decode_len"] - 1)
            tr.mark_retire(obs.rebase(t2))
            obs.trace_finish(tr)

    def _decode_per_token(self, nxt, cache, S: int, steps: int):
        """One decode-step call per token (the oracle's host loop).
        Returns ((B, steps) tokens, decode steps run)."""
        toks = [nxt]
        for pos in range(S, S + steps - 1):
            _, nxt, cache = self._decode(self.params, nxt[:, None], cache,
                                         pos)
            toks.append(nxt)
        return torch.stack(toks, 1), steps - 1

    def stats(self) -> Dict:
        """Engine counters (``repro``'s shared schema; ``batches`` is its
        alias of ``dispatches``) and the port's additions (``prefills`` to
        ``device``)."""
        st = _engine_stats_view(self.obs, "batch")
        st["batches"] = st["dispatches"]
        v = self.obs.registry.value
        st["prefills"] = int(v("engine.prefills"))
        st["decode_steps"] = int(v("engine.decode_steps"))
        st["cache_bytes"] = self._cache_bytes
        st["dispatch_kinds"] = sorted(self._kinds)
        st["quant_policy"] = self.quant.describe()
        st["cache_dtype"] = str(self.cache_dtype).split(".")[-1]
        st["prefill_lanes"] = self._contract.report()
        st["device"] = str(self.device)
        return st


class ContinuousEngine:
    """Continuous-batching engine: paged KV pool + token-budget scheduler.

    Every submitted request reaches exactly one terminal status.  Greedy
    outputs equal a B=1 run of each request, including across preemption.
    ``device`` defaults to the CUDA card; ``params`` must already be on it.
    ``decode_steps`` counts forward passes of the decode loop and
    ``prefills`` counts prefill calls (both also in ``stats()``).

    The numerics capture rides ``obs.enabled``; ``capture=False`` opts an
    enabled ``obs`` out of it (the middle arm of the overhead
    measurement: traces and spans without the health plane).
    ``shadow_sample`` replays that fraction of FINISHED requests through
    the float32 dense-cache oracle between dispatches
    (``obs/health.py:ShadowOracle``).  ``faults`` (``serve/faults.py:
    FaultInjector``) fails allocations, delays dispatches and poisons slots;
    the NaN guard retires a poisoned slot FAILED.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_tokens_in_flight: Optional[int] = None,
                 decode_chunk: int = 8, sample: bool = False,
                 temperature: float = 1.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 precompute: bool = True, paged_attn: str = "stream",
                 quant: Optional[QuantPolicy] = None,
                 admission: str = "optimistic",
                 max_queue: Optional[int] = None,
                 max_preemptions: int = 4, nan_guard: bool = True,
                 obs: Optional[Obs] = None, faults=None,
                 shadow_sample: float = 0.0,
                 capture: Optional[bool] = None, device=None, mesh=None):
        if paged_attn not in ("stream", "gather"):
            raise ValueError(f"paged_attn {paged_attn!r}: "
                             f"expected 'stream' or 'gather'")
        reasons = kvc.servable_reasons(cfg)
        if reasons:
            raise ValueError(f"{cfg.name} is not continuous-servable: "
                             f"{'; '.join(reasons)}")
        self.device = _engine_device(params, device)
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
        self.faults = faults
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
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.make_host_mesh(self.device))
        # keep the page dim DP-divisible (page_pool_spec would otherwise
        # replicate the pool over the data-parallel ranks)
        num_pages = dist_sharding.dp_round_up(num_pages, self.mesh)
        self.num_pages = num_pages
        self.pool = kvc.build_pool(cfg, num_pages, page_size, self.quant,
                                   device=self.device)
        # telemetry: the registry backs stats(); the allocator and the
        # scheduler write their own gauges and counters into it
        self.obs = obs if obs is not None else Obs()
        self.obs.profiler.bind_device(self.device)
        reg = self.obs.registry
        self._capture = (self.obs.enabled if capture is None
                         else bool(capture) and self.obs.enabled)
        self.block_table = kvc.BlockTable(
            kvc.PageAllocator(num_pages, registry=reg,
                              fault=(faults.alloc_fault
                                     if faults is not None else None)),
            max_slots, page_size, self.max_pages_per_slot)
        self.scheduler = Scheduler(self.block_table, max_seq=max_seq,
                                   max_tokens_in_flight=max_tokens_in_flight,
                                   registry=reg, admission=admission,
                                   max_queue=max_queue,
                                   max_preemptions=max_preemptions)
        # the control-plane gauges sampled at every dispatch end (the
        # Chrome trace's counter tracks)
        for gname in ("pool.free_pages", "sched.queue_depth",
                      "sched.tokens_in_flight"):
            self.obs.profiler.watch(gname)
        self._loop = dec.make_paged_decode_loop(
            cfg, decode_chunk, sample=sample, temperature=temperature,
            eos_id=eos_id, seed=seed, nan_guard=nan_guard,
            paged_impl=paged_attn, capture_stats=self._capture)
        # the decode step's static buffers (on the card its CUDA graph,
        # captured here, before the first request)
        with torch.no_grad():
            self._slots = self._loop.slots(self.params, self.pool, max_slots,
                                           self.max_pages_per_slot)
        self._prefills: Dict[int, object] = {}
        self._cur = np.zeros(max_slots, np.int32)
        self._pos = np.zeros(max_slots, np.int32)
        self._rem = np.zeros(max_slots, np.int32)
        self._table_version = -1            # BlockTable.version staged
        self._ctr = {n: reg.counter(n) for n in ENGINE_COUNTERS}
        self._c_anom = reg.counter("engine.anomalies")
        self._c_steps = reg.counter("engine.decode_steps")
        self._c_prefills = reg.counter("engine.prefills")
        self._h_prefill = reg.histogram("engine.prefill_dispatch_s")
        self._h_chunk = reg.histogram("engine.decode_chunk_s")
        self._h_occup = reg.histogram("sched.slot_occupancy",
                                      bounds=RATIO_BUCKETS)
        self._h_attn_bytes = reg.histogram("attn.bytes_per_token",
                                           bounds=BYTES_BUCKETS)
        self._c_growths = reg.counter("quant.scale_growths")
        attn = kvc.attention_bytes_per_position(self.pool)
        self._attn_per_pos = attn["per_pos"]
        self._counts = ServingCounts(self.params, cfg, attn["widest"])
        # numerics health plane: folds the capture of the prefill and
        # decode steps, so the NaN guard becomes the degenerate case of
        # labelled absmax / entropy / margin histograms
        self._health = HealthPlane(reg) if self._capture else None
        # quantization telemetry: the int8 pool's prefill saturation census
        # (values at the rail), the planes' census, and a host copy of the
        # pool's scales whose growth each decode dispatch counts
        self._c_kv_clip = reg.counter("quant.clip.kv_clipped")
        self._c_kv_total = reg.counter("quant.clip.kv_total")
        self._g_kv_clip = reg.gauge("quant.kv_clip_rate")
        if self._capture and self.quant.quant_weights:
            prep = plane_clip_report(self.params)
            reg.counter("quant.clip.plane_clipped").inc(prep["clipped"])
            reg.counter("quant.clip.plane_total").inc(prep["total"])
            reg.gauge("quant.plane_clip_rate").set(
                prep["clipped"] / max(prep["total"], 1))
        self._scales_host = (kvc.pool_scale_map(self.pool)
                             if self._capture and self.quant.kv_quantized
                             else None)
        self._h_scale = {}
        if self._scales_host is not None:
            for k in ("k_scale", "v_scale"):
                self._h_scale[k] = reg.histogram("quant." + k,
                                                 bounds=SCALE_BUCKETS)
            self._h_grow = reg.histogram("quant.scale_grow_ratio",
                                         bounds=RATIO_BUCKETS)
            # a grown page rescales its resident int8 values: each
            # element's round-off is at most new_scale / 2
            self._c_requant = reg.counter("quant.requant_error_bound")
        self._shadow = None
        if shadow_sample > 0.0:
            if not precompute:
                raise ValueError("shadow_sample needs precompute=True: the "
                                 "oracle bakes float32 planes from the "
                                 "generators")
            self._shadow = ShadowOracle(cfg, self.params, policy=self.quant,
                                        registry=reg, sample=shadow_sample,
                                        seed=seed, page_size=page_size)
        self._traces: Dict[int, object] = {}     # submission order -> trace
        self._t0_perf = None                # serve-clock origin (perf)
        self._results: Dict[int, Dict] = {}      # order -> terminal result
        self._cancels: set = set()          # request ids pending cancel
        self._stall_streak = 0              # consecutive all-stalled rounds
        self._stall_limit = 3               # then FAIL the youngest stalled
        # every counter above now exists at its true zero: SLO rate
        # windows cover the whole serve
        self.obs.baseline()

    # -- public lifecycle API ---------------------------------------------
    def _now(self) -> float:
        """Seconds on the serve clock (0 at the first submit)."""
        if self._t0_perf is None:
            self._t0_perf = time.perf_counter()
        return time.perf_counter() - self._t0_perf

    def reset_serve_clock(self) -> None:
        """Re-anchor the serve clock at the next submit or step (a fleet
        replica adopting a warmed engine: arrival and deadline stamps are
        router-relative).  Only while idle: in-flight work carries stamps
        on the current clock."""
        if not self.scheduler.idle:
            raise RuntimeError("reset_serve_clock with work in flight")
        self._t0_perf = None

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
        if self.obs.enabled:
            # the timeline starts at the (possibly simulated) arrival, so
            # queue_s covers the admission wait
            self._traces[order] = self.obs.trace_start(
                request.id, order, len(request.prompt),
                self.obs.rebase(self._t0_perf) + arrival_s)
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
        with dist_ctx.activation_policy(self.mesh):
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
        with dist_ctx.activation_policy(self.mesh):
            while not self.scheduler.idle:
                if not self._step(self._now()):
                    raise RuntimeError("drain stall: in-flight work cannot "
                                       "make progress")
            if self._shadow is not None:
                self._shadow.drain()
        self.obs.close()
        return [self._results[o] for o in sorted(set(self._results) - before)]

    def result(self, order: int, pop: bool = False) -> Optional[Dict]:
        return (self._results.pop(order, None) if pop
                else self._results.get(order))

    @property
    def anomalies(self) -> int:
        """Cumulative NaN / Inf-guard trips (the health signal a fleet
        replica folds into its DEGRADED transitions)."""
        return int(self._c_anom.value)

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
        with dist_ctx.activation_policy(self.mesh):
            self._serve(gate)
        return [self._results.pop(o) for o in orders]

    def _serve(self, gate: bool) -> None:
        """``generate``'s loop: steps until the scheduler is idle (with
        ``gate``, sleeping until the queue head's arrival)."""
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
        if self._shadow is not None:
            # pending replays publish agreement / drift before stats()
            self._shadow.drain()

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
        t_pre = self.obs.rebase(time.perf_counter())
        for idx, entry in prep.preempted:
            self._rem[idx] = 0              # victim's slot is dead on device
            progress = True
            tr = self._traces.get(entry.order)
            if tr is not None:
                tr.mark_preempt(t_pre, len(entry.resume_tokens))
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
        if self._shadow is not None:
            self._shadow.tick()     # at most one replay, off the hot path
        self.obs.tick()             # the emitter rides the dispatch cadence
        return progress

    def _prefill_fn(self, n_pages: int):
        fn = self._prefills.get(n_pages)
        if fn is None:
            fn = dec.make_prefill_pack_step(self.cfg, n_pages, self.page_size,
                                            capture_stats=self._capture)
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
        batch = {"tokens": torch.as_tensor(toks[None], device=self.device),
                 **frontend_inputs(self.cfg, 1, self.device)}
        pages = torch.as_tensor(self.block_table.pages(slot.index)[:n_pages],
                                dtype=torch.int64, device=self.device)
        with torch.no_grad():
            nxt, ok, self.pool, pstats = self._prefill_fn(n_pages)(
                self.params, batch, self.pool, pages, S)
            first, ok = int(nxt), bool(ok)
            # the capture is one flat vector: one transfer a prefill
            arr = (None if pstats is None
                   else pstats.cpu().numpy().astype(np.float64))
        synchronize(self.device)
        t1 = time.perf_counter()
        dt = t1 - t0
        obs = self.obs
        if obs.enabled:
            flops, nbytes = self._counts.prefill([S])
            obs.profiler.on_dispatch(
                obs.profiler.register(dec.prefill_kind(n_pages), flops,
                                      nbytes),
                obs.rebase(t0), obs.rebase(t1))
            self._h_prefill.observe(dt)
        self._ctr["prefill_s"].inc(dt)
        self._ctr["prompt_tokens"].inc(S)
        self._ctr["padded_prompt_tokens"].inc(spad)
        self._c_prefills.inc()
        slot.prefill_s = dt
        if arr is not None:
            # fold BEFORE the guard: a poisoned prefill bumps
            # health.nonfinite_* in the dispatch the guard retires it
            # ([logit(4) | kv_clipped | kv_total | act_absmax...])
            self._health.on_prefill({"logit": arr[:4],
                                     "act_absmax": arr[6:]})
            if arr[5] > 0:
                self._c_kv_clip.inc(float(arr[4]))
                self._c_kv_total.inc(float(arr[5]))
                self._g_kv_clip.set(self._c_kv_clip.value
                                    / max(self._c_kv_total.value, 1.0))
        tr = self._traces.get(slot.order)
        if self.nan_guard and not ok:
            # poisoned prefill: never stream a garbage first token
            self._c_anom.inc()
            self._rem[slot.index] = 0
            if tr is not None and tr.admit_s is None:
                tr.mark_admit(obs.rebase(self._t0_perf) + slot.admit_s)
            self._finish(slot, FAILED)
            return
        slot.tokens.append(first)
        slot.pos = S                       # position of the token in flight
        slot.budget -= 1
        self._cur[slot.index] = first
        self._pos[slot.index] = S
        self._rem[slot.index] = slot.budget
        self._ctr["tokens"].inc()          # the prefill-emitted token
        if tr is not None:
            if tr.admit_s is None:         # first admission of the request
                tr.mark_admit(obs.rebase(self._t0_perf) + slot.admit_s)
                tr.mark_first_token(obs.rebase(t1))
            else:                          # recompute-prefill after preempt
                tr.mark_chunk(obs.rebase(t1), 1)
        if self._scales_host is not None:
            # fresh pages carry new scales (not growth): census them and
            # refresh the host copy so the next decode diff is clean
            new = kvc.pool_scale_map(self.pool)
            for k, h in self._h_scale.items():
                h.observe_many(new[k][(new[k] != self._scales_host[k])
                                      & (new[k] > 0)])
            self._scales_host = new
        if (len(slot.tokens) >= slot.total_budget
                or (self.eos_id is not None and first == self.eos_id)):
            self._rem[slot.index] = 0
            self._finish(slot)
        elif slot.deadline_s is not None and self._now() > slot.deadline_s:
            self._rem[slot.index] = 0
            self._finish(slot, TIMEOUT)

    def _dispatch_decode(self, runnable, stalled) -> None:
        if self.faults is not None:
            delay = self.faults.dispatch_delay()
            if delay > 0.0:
                time.sleep(delay)           # injected control-plane hiccup
            victim = self.faults.pick_corruption(runnable)
            if victim is not None:
                poison_slot_pages(self.pool,
                                  self.block_table.pages(victim.index)[0])
        t0 = time.perf_counter()
        # stalled slots (no pages for the next chunk) are masked out of this
        # dispatch: rem=0 freezes them, their budget is restored afterwards
        rem_dispatch = self._rem.copy()
        for s in stalled:
            rem_dispatch[s.index] = 0
        table = self._slots.table           # the captured step reads it
        if self._table_version != self.block_table.version:
            table.copy_(torch.from_numpy(self.block_table.table))
            self._table_version = self.block_table.version
        host = torch.from_numpy
        pos_before = self._pos.copy()
        with torch.no_grad():
            buf, cur, self.pool, pos, rem, done, anom, steps = self._loop(
                self.params, host(self._cur), self.pool, table,
                host(self._pos), host(rem_dispatch))
            buf, cur, pos, rem, done, anom = (
                t.cpu().numpy() for t in (buf, cur, pos, rem, done, anom))
            dstats = (None if self._loop.last_stats is None
                      else self._loop.last_stats.cpu().numpy())
        synchronize(self.device)
        t1 = time.perf_counter()
        dt = t1 - t0
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
        advanced = rem_dispatch - rem_after
        if self.obs.enabled:
            self._observe_decode(runnable, advanced, pos_before, steps,
                                 dstats, t0, t1)
        t_chunk = self.obs.rebase(t1)
        for slot in runnable:
            b = slot.index
            n = int(advanced[b])
            if n:
                slot.tokens.extend(buf[b, :n].tolist())
                slot.pos = int(self._pos[b])
                self._ctr["tokens"].inc(n)
                tr = self._traces.get(slot.order)
                if tr is not None:
                    tr.mark_chunk(t_chunk, n)
            if anom[b]:
                self._c_anom.inc()
                self._finish(slot, FAILED)
            elif done[b]:
                self._finish(slot)

    def _observe_decode(self, runnable, advanced, pos_before, steps,
                        dstats, t0, t1) -> None:
        """A decode dispatch's profiler span, histograms, health fold and
        int8-pool scale census (obs enabled)."""
        obs = self.obs
        # slot b decoded advanced[b] tokens from pos_before[b], each
        # attending to its position + 1 keys
        ctx = [int(p) + 1 + i for p, n in zip(pos_before, advanced)
               for i in range(int(n))]
        flops, nbytes = self._counts.decode(ctx, steps, len(runnable))
        obs.profiler.on_dispatch(
            obs.profiler.register(dec.DECODE_CHUNK_KIND, flops, nbytes),
            obs.rebase(t0), obs.rebase(t1))
        self._h_chunk.observe(t1 - t0)
        self._h_occup.observe(len(runnable) / max(self.max_slots, 1))
        live = self._pos[[s.index for s in runnable if advanced[s.index]]]
        if live.size:
            # the bytes attention streamed for each slot that advanced
            self._h_attn_bytes.observe_many(self._attn_per_pos * live)
        if dstats is not None:
            # rows of slots that took no step hold init sentinels or stale
            # rows and are skipped by the fold
            self._health.on_decode(dstats, steps=advanced)
        if self._scales_host is not None:
            new = kvc.pool_scale_map(self.pool)
            grown = 0
            for k, old in self._scales_host.items():
                g = new[k] > old
                if g.any():
                    grown += int(g.sum())
                    ns, olds = new[k][g], old[g]
                    self._c_requant.inc(float(0.5 * ns.sum()))
                    self._h_grow.observe_many((olds / ns)[ns > 0])
                    self._h_scale[k].observe_many(ns)
            self._c_growths.inc(grown)
            self._scales_host = new

    # -- terminal transitions ---------------------------------------------
    def _finish(self, slot, status: Optional[str] = None) -> None:
        """Retire a slot-resident request (``status`` None: EOS or budget)."""
        if status is None:
            toks = slot.tokens
            status = (FINISHED_EOS
                      if (self.eos_id is not None and toks
                          and toks[-1] == self.eos_id)
                      else FINISHED_BUDGET)
        if (self._shadow is not None
                and status in (FINISHED_EOS, FINISHED_BUDGET)):
            # only cleanly finished requests are replayable (their whole
            # greedy trajectory exists); replays run between dispatches
            self._shadow.maybe_enqueue(np.asarray(slot.request.prompt),
                                       len(slot.tokens))
        now = self._now()
        prefill_s = getattr(slot, "prefill_s", 0.0)
        arrival, admit = slot.arrival_s, slot.admit_s
        self._rem[slot.index] = 0           # device slot is dead
        res = self.scheduler.retire(slot, status)  # releases the pages
        tr = self._traces.pop(res["order"], None)
        if tr is not None:
            # one timeline: the result's latencies come from the trace
            tr.status = status
            # clamp: a cancel or timeout can land before a simulated arrival
            tr.mark_retire(max(self.obs.rebase(self._t0_perf) + now,
                               tr.enqueue_s))
            self.obs.trace_finish(tr)
            decode_s = tr.decode_s if tr.decode_s is not None else 0.0
            res.update({
                "tokens_per_s": res["decode_len"] / max(decode_s, 1e-9),
                "prefill_s": tr.prefill_s,
                "decode_s": decode_s,
                "queue_s": tr.queue_s,
                "latency_s": tr.latency_s,
            })
        else:
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
        now = self._now()
        tr = self._traces.pop(order, None)
        res = self._results[order] = {
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
        if tr is not None:
            tr.status = status
            tr.mark_retire(max(self.obs.rebase(self._t0_perf) + now,
                               tr.enqueue_s))
            self.obs.trace_finish(tr)
            res["latency_s"] = tr.latency_s
            res["queue_s"] = tr.latency_s   # never admitted: all queue wait

    # -- telemetry --------------------------------------------------------
    def stats(self) -> Dict:
        """Engine + scheduler telemetry (``repro``'s schema) and the port's
        additions (``decode_steps``, ``prefills``, ``decode_graphs``,
        ``decode_capture_s``, ``device``)."""
        v = self.obs.registry.value
        st = _engine_stats_view(self.obs, "continuous")
        st["decode_dispatches"] = st["dispatches"]
        st.update(self.scheduler.stats())
        st["anomalies"] = int(v("engine.anomalies"))
        st["decode_steps"] = int(v("engine.decode_steps"))
        st["prefills"] = int(v("engine.prefills"))
        st["free_pages"] = int(v("pool.free_pages"))
        low = self.obs.registry.gauge("pool.free_pages").min_seen
        st["min_free_pages"] = (int(low) if low is not None
                                else st["free_pages"])
        st["pages_alloc"] = int(v("pool.pages_alloc"))
        st["pages_freed"] = int(v("pool.pages_freed"))
        st["scale_growths"] = int(v("quant.scale_growths"))
        kv_total = v("quant.clip.kv_total")
        st["kv_clip_rate"] = (v("quant.clip.kv_clipped") / kv_total
                              if kv_total else None)
        if self._health is not None:
            st["health"] = self._health.stats()
        if self._shadow is not None:
            st["shadow_oracle"] = self._shadow.stats()
        st["pool_bytes"] = kvc.pool_bytes(self.pool)
        st["kv_pool_bytes"] = st["pool_bytes"]
        st["quant_policy"] = self.quant.describe()
        st["prefill_buckets"] = sorted(self._prefills)
        st["attention_impl"] = self.paged_attn
        st["decode_graphs"] = self._loop.captures
        st["decode_capture_s"] = self._loop.capture_s
        st.update(kvc.attention_memory_est(
            self.pool, self.max_slots, self.max_pages_per_slot,
            self.page_size, self.paged_attn))
        st["decode_peak_bytes_est"] = (st["pool_bytes"]
                                       + st["peak_attention_bytes"])
        st["device"] = str(self.device)
        return st
