"""Roofline accounting for the port (port of ``repro/roofline/analysis.py``
:39-275): the hardware specs every "fraction of roofline" divides by, and
the model's useful-work counts.

* ``HardwareSpec`` and the presets: ``repro``'s (``tpu-v5e``, ``tpu-v4``,
  ``host-cpu``, ``gpu-generic``) plus ``h100``, NVIDIA's data-sheet rates
  of one H100 SXM (80 GB HBM3, 700 W): 989e12 dense bf16 FLOP/s on the
  tensor cores and 3.35e12 HBM bytes/s.  ``detect_hardware`` picks
  ``h100`` for an H100, ``gpu-generic`` for any other CUDA card and
  ``host-cpu`` for the CPU.
* ``bound`` and ``rfft_flops``: the least time for a kernel's work on the
  H100 (the larger of its bytes over the memory rate and its operations
  over the peak rate of the operands' type) and the operations of a real
  FFT; ``chip_smoke.py`` and the profiler (``obs/prof.py``) count with
  these.
* ``model_flops_per_token``, ``count_params``, ``seq_mixer_flops_per_token``
  and ``slstm_scan_correction``: ``repro``'s compression-aware counts (a
  block-circulant projection costs its FFT pipeline's FLOPs, MoE experts
  count ``top_k`` per token, attention scores and AV in the sequence-mixer
  term).  ``repro`` walks a parameter pytree whose segments stack their
  layers on a leading axis; here the walk is over the ``nn.Module``'s
  named parameters, one module a layer, and the sums are the same.

* ``StepCost``, ``collective_bytes`` and ``cell_report``: the cost of one
  traced step (``repro``'s ``:97-166`` and ``:275-341``; the dry run,
  ``launch/dryrun.py``).  ``repro`` reads a compiled XLA executable: its
  cost analysis (per-device FLOPs and bytes accessed), its memory
  analysis and its optimized HLO's collectives.  The port has no
  compiled executable; it records one step traced over ``DTensor``s
  under ``FakeTensorMode`` (``dist/spmd.py``) with ``StepCost``, a
  dispatch mode that sees each rank's LOCAL operations (it steps aside
  for ``DTensor``s, whose local shards then reach it), so the counts are
  per device, as XLA's are:

  - FLOPs: torch's FLOP formulas (``torch.utils.flop_counter``) of every
    product (mm, bmm, addmm, baddbmm, convolutions, SDPA), 2 m n k each;
    elementwise operations are not counted.  What runs as plain PyTorch
    on the card counts so too: the batch prefill's DFTs around
    ``spectral_matmul`` are products with ``dft_mats``
    (``core/circulant.py``, k <= 512), 2 k kf a row and plane, and so is
    the planes' DFT a training step derives per call.
  - Bytes accessed: every operation's tensor operands and results once
    each (an in-place one its operands; views, allocations and metadata
    queries such as ``prim.device`` nothing), as XLA's "bytes accessed"
    counts every operand and result touch: an upper bound on HBM
    traffic.
  - A kernel launch (the dry run traces under ``kernels/standin.py``,
    where each wrapper runs its card branch and its launch is a stand-in)
    adds that kernel's own FLOPs and compulsory bytes
    (``StepCost.launched``: each kernel module's ``work``, a DFT at 2.5 k
    log2 k); the wrapper's allocations are tracked for memory and count
    no bytes, so nothing is counted twice.
  - Collectives: the result bytes per device of every functional
    collective (``_c10d_functional``) ``DTensor`` issues, under
    ``repro``'s kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``, ``collective-broadcast``) and
    ``total``.
  - Memory: argument bytes are the local bytes of the step's inputs (a
    sharded leaf's shard) that one of its operations reads (``jax.jit``
    prunes an argument its program never reads: the generators beside
    baked planes at serve, the planes a MAC does not take), output and
    alias bytes the outputs' (the port
    updates the cache, and in training the state, in place: those outputs
    alias their inputs), temp bytes the peak of the storages the step
    allocates, live at once, less the outputs it made (a returned slice
    counts its own bytes: the rest of its storage stays temp).

  The report's defaults are the port's ``h100`` spec.  Its collective
  term divides by ``H100.link_bw``, one NVLink 4 direction: the 256 and
  512 cards of the production meshes span nodes, so it is an NVLink-only
  bound (inter-node links are slower).  ``repro``'s
  ``slstm_scan_correction`` is kept but the report adds none: the port's
  trace runs every step of the sLSTM scan, where XLA costs a while body
  once.

Left out: ``xla_cost_analysis`` and ``CompiledCompat`` (they normalise the
return of XLA's ``cost_analysis()`` across jax versions; the port's record
is its own).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ArchConfig, ShapeSpec
from ..core.circulant import bc_flops
from ..dist.spmd import count_times


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak rates of one device: the denominators of every roofline
    question.  ``ridge_flops_per_byte`` is the arithmetic intensity at
    which work stops being memory-bound on this part."""
    name: str
    peak_flops: float            # FLOP/s per chip
    hbm_bw: float                # HBM bytes/s per chip
    link_bw: float = 0.0         # bytes/s per interconnect link

    @property
    def ridge_flops_per_byte(self) -> float:
        return self.peak_flops / self.hbm_bw


TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9)
TPU_V4 = HardwareSpec("tpu-v4", peak_flops=275e12, hbm_bw=1.2e12,
                      link_bw=50e9)
# one server-CPU socket, order of magnitude (``repro``'s round numbers: a
# sanity scale on the host, not a calibrated claim)
HOST_CPU = HardwareSpec("host-cpu", peak_flops=2e11, hbm_bw=5e10)
GPU_GENERIC = HardwareSpec("gpu-generic", peak_flops=1e14, hbm_bw=2e12,
                           link_bw=25e9)
# H100 SXM, NVIDIA data sheet: dense bf16 on the tensor cores, HBM3 rate,
# one NVLink 4 direction (18 links x 25 GB/s)
H100 = HardwareSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9)

HARDWARE_PRESETS = {s.name: s for s in (TPU_V5E, TPU_V4, HOST_CPU,
                                        GPU_GENERIC, H100)}

# the H100's peak rate by operand type: float32 on the CUDA cores, bf16 on
# the tensor cores (dense)
H100_PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def detect_hardware(device=None) -> HardwareSpec:
    """The preset of ``device`` (default: the CUDA card where there is
    one, else the CPU): ``h100`` for an H100, ``gpu-generic`` for any other
    CUDA card, ``host-cpu`` for the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return HOST_CPU
    if "H100" in torch.cuda.get_device_name(device):
        return H100
    return GPU_GENERIC


def bound(nbytes: float, flops: float, dtype: torch.dtype,
          hbm_bw: float = H100.hbm_bw) -> Tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``flops``
    operations on ``dtype`` operands on the H100, and what bounds it:
    ``"bytes"`` (over the memory rate) or ``"operations"`` (over the peak
    rate of the type)."""
    t_bytes = nbytes / hbm_bw
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rfft_flops(rows: int, k: int) -> float:
    """Operations of ``rows`` real FFTs of length ``k`` (or their inverses):
    2.5 k log2 k each, half a complex FFT's 5 k log2 k.  The least a
    transform needs; the kernels multiply by dense DFT panels instead."""
    return 2.5 * rows * k * math.log2(k)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: compression-aware useful-work accounting
# ---------------------------------------------------------------------------
_DENSE_LEAVES = ("w", "up", "gate", "down", "router", "wh", "ifg")


def model_flops_per_token(params: nn.Module, cfg: ArchConfig) -> float:
    """Projection FLOPs per processed token (forward only; attention
    scores / AV and the embedding gather excluded, the tied LM head
    counted): ``repro``'s rules leaf by leaf over ``params``'s named
    parameters, without the layer axis ``repro``'s segments stack."""
    topk = max(cfg.moe.top_k, 1)
    total = 0.0
    for path, leaf in params.named_parameters():
        names = path.split(".")
        leaf_name = names[-1]
        is_expert = "experts" in names
        shape = tuple(leaf.shape)
        if leaf_name == "table":                      # tied LM head matmul
            total += 2.0 * shape[0] * shape[1]
            continue
        # an expert stack of circulant generators is (E, p, q, k)
        if leaf_name == "wc" or (is_expert and len(shape) >= 4 and
                                 leaf_name in ("up", "gate", "down")
                                 and shape[-1] <= 512):
            p_, q_, k_ = shape[-3], shape[-2], shape[-1]
            stack = math.prod(shape[:-3])
            if is_expert:                             # (E, p, q, k)
                stack = math.prod(shape[:-4]) * topk
            total += float(stack) * bc_flops(1, q_ * k_, p_ * k_, k_)
            continue
        if len(shape) >= 2 and leaf_name in _DENSE_LEAVES:
            n_in, n_out = shape[-2], shape[-1]
            stack = math.prod(shape[:-2])
            if is_expert:                             # (E, in, out)
                stack = math.prod(shape[:-3]) * topk
            total += float(stack) * 2.0 * n_in * n_out
    return total


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def seq_mixer_flops_per_token(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Algorithmic FLOPs a token of the sequence mixers (attention scores +
    AV, recurrent state updates), ``repro``'s PaLM-style convention
    extended to the recurrent kinds.  ``shape.seq_len`` is the context: a
    decode token attends to ``seq_len`` positions, a prefill token to half
    of them on average (causal)."""
    from ..models.transformer import segments_for
    S = shape.seq_len
    a = cfg.attention
    hd = a.num_heads * a.head_dim

    def ctx(kind: str) -> float:
        w = a.sliding_window
        avg = S if shape.is_decode else S / 2          # causal average
        if kind in ("attn_local", "moe_swa") and w:
            return min(w, avg)
        return avg

    total = 0.0
    if cfg.is_encoder_decoder:
        total += cfg.num_layers * 4.0 * hd * (S if shape.is_decode else S / 2)
        total += cfg.num_layers * 4.0 * hd * cfg.encoder_seq
        enc_tokens_ratio = (cfg.encoder_seq / max(S, 1)
                            if not shape.is_decode else cfg.encoder_seq)
        total += (cfg.encoder_layers * 4.0 * hd * cfg.encoder_seq *
                  (enc_tokens_ratio if shape.is_decode else
                   cfg.encoder_seq / max(S, 1)))
        return total
    for pattern, n in segments_for(cfg):
        for kind in pattern:
            if kind in ("attn", "attn_local", "moe", "moe_swa"):
                total += n * 4.0 * hd * ctx(kind)
            elif kind == "rec":
                total += n * 20.0 * (cfg.recurrent.lru_width or cfg.d_model)
            elif kind == "mlstm":
                d_in = int(cfg.d_model * cfg.recurrent.proj_factor)
                c = min(cfg.mlstm_chunk if not cfg.unroll_scan else 256, S)
                total += n * (2.0 * d_in * c + 8.0 * d_in *
                              (d_in // max(cfg.recurrent.mlstm_heads, 1)))
            elif kind == "slstm":
                total += n * (8.0 * cfg.d_model ** 2 + 64.0 * cfg.d_model)
    return total


def slstm_scan_correction(cfg: ArchConfig, shape: ShapeSpec,
                          dp_size: int) -> float:
    """FLOPs of the sLSTM time recurrence beyond one costed scan body
    (``repro``'s correction for XLA's once-counted while body): (S - 1)
    bodies of h @ W_h (2 b d 4d) and ~16 4d b gate operations a layer."""
    pattern = cfg.recurrent.pattern or ()
    if "slstm" not in pattern or shape.is_decode:
        return 0.0
    groups = cfg.num_layers // max(len(pattern), 1)
    n_slstm = sum(k == "slstm" for k in pattern) * groups
    b_local = max(shape.global_batch // dp_size, 1)
    d = cfg.d_model
    body = 2.0 * b_local * d * 4 * d + 16.0 * b_local * 4 * d
    factor = 3.0 if shape.kind == "train" else 1.0
    return n_slstm * (shape.seq_len - 1) * body * factor


def decode_shape(context: int, batch: int = 1) -> ShapeSpec:
    """A decode cell of ``batch`` tokens over ``context`` positions."""
    return ShapeSpec("decode", int(context), int(batch), "decode")


def prefill_shape(seq: int, batch: int = 1) -> ShapeSpec:
    """A prefill cell of ``batch`` sequences of ``seq`` tokens."""
    return ShapeSpec("prefill", int(seq), int(batch), "prefill")


# ---------------------------------------------------------------------------
# Least bytes of a serving dispatch (the profiler's memory term)
# ---------------------------------------------------------------------------
def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def serving_weight_bytes(params: nn.Module, cfg: ArchConfig,
                         tokens: Optional[int] = None) -> float:
    """Bytes one forward pass of ``tokens`` rows must read of the weights
    as served: every baked plane (float32, int8 or packed int4, scales
    included) and every parameter no plane replaces (norms, dense
    projections, the tied embedding table the LM head reads whole).  A
    generator whose planes are baked (a projection's ``wc``, an expert
    stack, the projections a fused cache shadows) is not read.  An expert
    stack's planes count the share of experts ``tokens`` rows can reach
    (``tokens * top_k / E``, at most all of them)."""
    from ..core.circulant import FusedProjections
    from ..layers.ffn import Experts
    from ..quant.codec import baked_caches
    topk = max(cfg.moe.top_k, 1)
    total, replaced = 0.0, set()
    for _, m, prefix, cache in baked_caches(params):
        nbytes = sum(_nbytes(t) for t in cache.values())
        if isinstance(m, Experts) and tokens is not None:
            E = cache["wr"].shape[0]
            nbytes *= min(1.0, tokens * topk / E)
        total += nbytes
        gen = getattr(m, prefix[:-len("_cache")], None)
        if isinstance(gen, torch.Tensor):
            replaced.add(id(gen))
        if isinstance(m, FusedProjections) and prefix == m.FUSED_CACHE:
            replaced.update(id(lin.wc) for lin in m.fused_linears())
    return total + sum(_nbytes(p) for p in params.parameters()
                       if id(p) not in replaced)


class ServingCounts:
    """The least work of a serving model's dispatches, for the profiler:
    ``prefill(lengths)`` and ``decode(contexts, passes, rows)`` give
    ``(flops, bytes)``.

    FLOPs are tokens x ``model_flops_per_token`` plus each token's
    ``seq_mixer_flops_per_token`` at its context.  Bytes are the weights
    as served (``serving_weight_bytes``) once a forward pass, plus the KV
    the attention layers write (prefill: each prompt position) or read
    (decode: each token's context), ``kv_bytes`` a layer and position in
    the cache's dtype; a windowed layer reads its window's."""

    def __init__(self, params: nn.Module, cfg: ArchConfig,
                 kv_bytes: float):
        from ..models.transformer import ATTN_KINDS, layer_kinds, window_for
        self.cfg = cfg
        self.params = params
        self.kv_bytes = float(kv_bytes)
        self.proj = model_flops_per_token(params, cfg)
        self._windows: Dict[int, int] = {}
        for kind in layer_kinds(cfg) if not cfg.is_encoder_decoder else ():
            if kind in ATTN_KINDS:
                w = window_for(kind, cfg)
                self._windows[w] = self._windows.get(w, 0) + 1
        if cfg.is_encoder_decoder:
            self._windows = {0: cfg.num_layers}
        self._weights: Dict[int, float] = {}
        self._mixer: Dict[Tuple[str, int], float] = {}

    def weight_bytes(self, rows: int) -> float:
        """``serving_weight_bytes`` of a pass over ``rows`` rows (only an
        MoE's expert share depends on them)."""
        rows = int(rows) if self.cfg.moe.num_experts else 0
        if rows not in self._weights:
            self._weights[rows] = serving_weight_bytes(
                self.params, self.cfg, rows if rows else None)
        return self._weights[rows]

    def _mix(self, kind: str, ctx: int) -> float:
        key = (kind, int(ctx))
        if key not in self._mixer:
            shape = (decode_shape(ctx) if kind == "decode"
                     else prefill_shape(ctx))
            self._mixer[key] = seq_mixer_flops_per_token(self.cfg, shape)
        return self._mixer[key]

    def _kv(self, contexts: np.ndarray) -> float:
        return self.kv_bytes * float(sum(
            n * (np.minimum(contexts, w) if w else contexts).sum()
            for w, n in self._windows.items()))

    def prefill(self, lengths: Iterable[int]) -> Tuple[float, float]:
        """One prefill pass over prompts of ``lengths`` true tokens."""
        lengths = np.asarray(list(lengths), np.int64)
        flops = sum(int(s) * (self.proj + self._mix("prefill", s))
                    for s in lengths)
        return (flops, self.weight_bytes(lengths.sum())
                + self._kv(lengths))

    def decode(self, contexts: Iterable[int], passes: int,
               rows: int) -> Tuple[float, float]:
        """``passes`` forward passes of ``rows`` rows that decoded one
        token for each entry of ``contexts`` (the positions it attends
        to)."""
        ctx = np.asarray(list(contexts), np.int64)
        flops = sum(self.proj + self._mix("decode", c) for c in ctx)
        return (flops, passes * self.weight_bytes(rows) + self._kv(ctx))


# ---------------------------------------------------------------------------
# The cost of one traced step (the dry run)
# ---------------------------------------------------------------------------
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")
# functional collectives (torch.ops._c10d_functional) by repro's kinds
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
    "permute_tensor": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _group_size(args, kwargs) -> int:
    """The ranks of a functional collective's group (its group name is its
    last string argument); a collective over one rank moves nothing."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    for name in reversed(names):
        try:
            return _resolve_process_group(name).size()
        except (KeyError, ValueError, RuntimeError):
            continue
    return 2


class StepCost(TorchDispatchMode):
    """Per-device FLOPs, bytes accessed, collective bytes and the peak of
    newly allocated storage of the operations run under it (module
    docstring).  It steps aside for ``DTensor`` arguments, so it sees
    each rank's local operations, and ignores what ``DTensor``'s sharding
    propagator runs on global shapes to learn an output's; enter it
    inside the fake mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self._live: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._args: Dict[int, int] = {}
        self._read: set = set()

    # the sharding propagator's methods that run an operation on GLOBAL
    # fake tensors to learn its output's shape (names across torch
    # versions); what runs inside them is no rank's work
    _PROPAGATORS = ("propagate", "propagate_op_sharding",
                    "propagate_op_sharding_non_cached",
                    "_propagate_tensor_meta",
                    "_propagate_tensor_meta_non_cached")

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        self._patched = []
        self._inside = 0
        for name in self._PROPAGATORS:
            fn = getattr(prop, name, None)
            if fn is None:
                continue
            had = name in vars(prop)
            self._patched.append((prop, name, had, vars(prop).get(name)))

            def wrapped(*a, _fn=fn, **kw):
                self._inside += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    self._inside -= 1
            setattr(prop, name, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        for prop, name, had, old in reversed(self._patched):
            if had:
                setattr(prop, name, old)
            else:
                delattr(prop, name)
        return super().__exit__(*exc)

    def launched(self, flops: float, nbytes: float) -> None:
        """Charge one kernel launch's own operations and bytes (the
        stand-in's, ``kernels/standin.py``), times ``count_times()``."""
        times = count_times()
        self.flops += times * float(flops)
        self.bytes_accessed += times * float(nbytes)

    def reads(self, t: torch.Tensor) -> None:
        """Note that a kernel launch reads ``t`` (the stand-in passes each
        pointer it is given): a watched argument so read counts in
        ``read_bytes``, as an operation's operand does."""
        key = id(t.untyped_storage())
        if key in self._args:
            self._read.add(key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def watch(self, tensors) -> None:
        """Note the storages of a step's arguments (a ``DTensor``'s local
        shard), so that ``read_bytes`` can tell which of them it read."""
        self._args = {}
        for t in _tensors(tensors):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            self._args[id(st)] = st.nbytes()
        self._read = set()

    def read_bytes(self) -> int:
        """Bytes of the watched arguments that an operation of the step
        read (XLA prunes the arguments a program never reads)."""
        return sum(n for key, n in self._args.items() if key in self._read)

    def live_bytes(self, tensors) -> int:
        """Bytes of ``tensors`` in the storages this step made: each
        storage's, up to the bytes of the tensors that view it (a step
        that returns a slice of a larger result, the prefill's last-position
        logits, holds the rest of that storage alive as temp)."""
        seen = {}
        for t in _tensors(tensors):
            t = getattr(t, "_local_tensor", t)
            key = id(t.untyped_storage())
            if key in self._live:
                seen[key] = seen.get(key, 0) + _nbytes(t)
        return sum(min(n, self._live[key]) for key, n in seen.items())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        if self._args:
            for t in _tensors((args, kwargs)):
                key = id(t.untyped_storage())
                if key in self._args:
                    self._read.add(key)
        times = count_times()
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(func.overloadpacket.__name__)
            if kind is not None and _group_size(args, kwargs) > 1:
                self.collectives[kind] += times * sum(_nbytes(t)
                                                      for t in _tensors(out))
            for t in _tensors(out):
                self._track(t)
            return out
        pkt = func.overloadpacket
        if pkt in self._flops_of:
            self.flops += times * float(self._flops_of[pkt](
                *args, **kwargs, out_val=out))
        rets = func._schema.returns
        alias = [r.alias_info for r in rets]
        if any(a is not None and not a.is_write for a in alias):
            return out                                  # a view
        if pkt in _ALLOCATIONS:                         # touches nothing
            for t in _tensors(out):
                self._track(t)
            return out
        if not any(a is not None for a in alias) and \
                next(_tensors(out), None) is None:
            return out              # a metadata query (prim.device)
        touched = (sum(_nbytes(t) for t in _tensors(args))
                   + sum(_nbytes(t) for t in _tensors(kwargs)))
        if not any(a is not None for a in alias):       # not in place
            touched += sum(_nbytes(t) for t in _tensors(out))
            for t in _tensors(out):
                self._track(t)
        self.bytes_accessed += times * touched
        return out


# operations that allocate storage and write none of it
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def collective_bytes(cost: "StepCost") -> Dict[str, int]:
    """Per-collective-kind result bytes (per device) of a traced step, and
    their ``total`` (``repro``'s keys)."""
    out = {k: int(cost.collectives.get(k, 0)) for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class StepRecord:
    """What ``cell_report`` reads of one traced step: the cost counts,
    the memory (``repro``'s ``memory_analysis()`` names) and the kernel
    launches a device makes (``kernels/standin.py:launch_counts``)."""
    flops: float
    bytes_accessed: float
    collectives: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    code_bytes: int = 0
    launches: Dict = dataclasses.field(default_factory=dict)


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree of (D)Tensors: a ``DTensor``'s
    local shard, a plain tensor whole."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(getattr(t, "_local_tensor", t))
    return total


def cell_model_flops(params: nn.Module, cfg: ArchConfig,
                     shape: ShapeSpec) -> float:
    """The useful FLOPs of one cell's step (``repro``'s convention): the
    forward FLOPs a token (projections and sequence mixers) times the
    tokens, three times that for a train step (forward and backward)."""
    fwd_per_tok = (model_flops_per_token(params, cfg) +
                   seq_mixer_flops_per_token(cfg, shape))
    if shape.kind == "train":
        return 3.0 * fwd_per_tok * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return fwd_per_tok * shape.global_batch * shape.seq_len
    return fwd_per_tok * shape.global_batch


def cell_report(record: StepRecord, cfg: ArchConfig, shape: ShapeSpec,
                mesh, spec: HardwareSpec = H100, params=None) -> Dict:
    """All roofline quantities of one traced cell, under ``repro``'s keys
    (``spec`` picks the denominators; the port's default is ``h100``).
    ``params`` is the model's module (its shapes) for ``model_flops`` and
    ``params``; built without allocation where not given."""
    from ..dist.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    chips = int(np.prod(list(sizes.values())))
    flops = float(record.flops)
    bytes_acc = float(record.bytes_accessed)
    mem = {"argument_bytes": int(record.argument_bytes),
           "output_bytes": int(record.output_bytes),
           "temp_bytes": int(record.temp_bytes),
           "alias_bytes": int(record.alias_bytes),
           "code_bytes": int(record.code_bytes)}
    bytes_per_device = (mem["argument_bytes"] + mem["output_bytes"] +
                        mem["temp_bytes"] - mem["alias_bytes"])
    coll = dict(record.collectives)
    terms = {"compute_s": flops / spec.peak_flops,
             "memory_s": bytes_acc / spec.hbm_bw,
             "collective_s": coll["total"] / (spec.link_bw or H100.link_bw)}
    dominant = max(terms, key=terms.get)
    if params is None:
        from ..models.registry import abstract_params
        params = abstract_params(cfg)
    model_flops = cell_model_flops(params, cfg, shape)
    hlo_global = flops * chips
    t_model = model_flops / chips / spec.peak_flops
    bound = max(terms.values())
    return {
        "hardware": spec.name,
        "chips": chips,
        "slstm_correction_flops": 0.0,
        "flops_per_device": flops,
        "bytes_accessed_per_device": bytes_acc,
        "bytes_per_device": bytes_per_device,
        "memory": mem,
        "collectives": coll,
        **terms,
        "dominant": dominant,
        "model_flops": model_flops,
        "params": count_params(params),
        "launches": dict(record.launches),
        "model_hlo_ratio": model_flops / hlo_global if hlo_global else 0.0,
        "roofline_frac_overlap": t_model / bound if bound else 0.0,
        "roofline_frac_serial": (t_model / sum(terms.values())
                                 if sum(terms.values()) else 0.0),
    }
