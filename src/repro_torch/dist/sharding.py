"""Mesh-aware sharding rule engine (port of ``repro/dist/sharding.py``).

Derives partition specs from *parameter path + shape* (plus a mesh and a
named strategy), so models never hard-code a layout.  The engine needs only
duck-typed mesh info: ``axis_names`` and ``devices.shape`` (``repro``'s
test fakes), or a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names`` and ``shape``), so rule derivation runs with zero
devices (tests, planning tools).  The rules are ``repro``'s, line for line
(its module docstring has the table); what differs:

* ``P`` is the port's own ``PartitionSpec``: a tuple of per-dim entries
  (None, an axis name, or a tuple of axis names).
* The port keeps each layer in its own module, where ``repro`` stacks a
  segment's layers along a leading dim under ``STACKED_ROOTS``.  A module
  name such as ``blocks.3.attn.q.wc_cache_wr`` is read as the path
  ``("blocks", "3", "attn", "q", "wc_cache", "wr")`` (``module_path``):
  the spec of a port leaf is ``repro``'s spec of the stacked leaf without
  its leading None (``models/convert.py`` maps the names).
* ``to_placements(spec, mesh)`` binds a spec to a ``DeviceMesh`` as one
  ``Shard`` / ``Replicate`` per mesh dim for ``torch.distributed.tensor``
  (``repro``'s ``to_shardings``).  A tensor dim that two mesh axes shard
  is split by them in mesh-dim order (DTensor's), where a jax spec's
  tuple order would be major first: the per-device bytes are the same.
* ``local_shape`` gives a leaf's per-device shape under a spec, for
  counting bytes a device holds without any device.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Data-parallel axes in nesting order; "pod" only exists on the 512-chip mesh.
DP_AXES = ("pod", "data")
MODEL_AXIS = "model"

# pytree roots whose children carry a stacked/scanned leading dim (params are
# jnp.stack'ed over the scan axis — that dim is structural, never sharded).
STACKED_ROOTS = frozenset({"segments", "enc_blocks", "dec_blocks"})

# Linear names whose *input* dim is the TP-sharded contraction (row parallel).
ROW_LINEAR = frozenset({"o", "down", "out"})

# Leaves that always replicate regardless of shape (tiny position tables).
REPLICATED_LEAVES = frozenset({"pos"})

# Spectral serving-cache planes (serve/params.py): (p, q, kf) real planes of
# rfft(wc), living under a `*_cache` dict next to the generator they mirror —
# they shard exactly like a `wc` of the same projection.
SPECTRAL_PLANES = frozenset({"wr", "wi", "ws1", "ws2"})

# Quantization scales of those planes (repro.quant: `<plane>_s`, (p, 1) per
# block row; experts (E, p, 1)).  Scales shard LIKE THEIR PAYLOAD's sharded
# dims they actually have: the block-row dim takes "model" exactly when the
# payload's block-row dim does (column-parallel projections; row-parallel
# planes model-shard their q dim, which a scale does not have, so row scales
# replicate).  Scales are tiny and never shard over data-parallel axes.
SPECTRAL_SCALES = frozenset({"wr_s", "wi_s", "ws1_s", "ws2_s"})

# Paged-pool quantization scales (serve/kvcache.py int8 pools): one f32 per
# (page, kv-head), leaf names `k_scale`/`v_scale`, shape (..., P, Hkv).
POOL_SCALES = frozenset({"k_scale", "v_scale"})

# Canonical core ranks per leaf kind: extra leading dims are stack dims.
_CORE_RANK = {"wc": 3, "w": 2, "table": 2,
              "wr": 3, "wi": 3, "ws1": 3, "ws2": 3,
              "wr_s": 2, "wi_s": 2, "ws1_s": 2, "ws2_s": 2}

STRATEGIES = {"2d": "2d", "megatron": "2d", "tokenpar": "tokenpar"}


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    an axis name, or a tuple of axis names (``jax.sharding.
    PartitionSpec``'s form, which also reads a 1-tuple as its one name;
    ``P()`` replicates every dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Mesh introspection (duck-typed: a DeviceMesh, or a fake with axis_names)
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` from anything with ``axis_names`` + ``devices``
    (``repro``'s fakes) or a ``DeviceMesh`` (``mesh_dim_names`` +
    ``shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return {str(n): int(s)
                for n, s in zip(tuple(mesh.mesh_dim_names), mesh.shape)}
    return {str(n): int(s)
            for n, s in zip(tuple(mesh.axis_names), np.shape(mesh.devices))}


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present on this mesh, outermost first."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in DP_AXES if a in sizes)


def _prod(vals) -> int:
    out = 1
    for v in vals:
        out *= int(v)
    return out


def _canon_strategy(strategy: str) -> str:
    try:
        return STRATEGIES[strategy]
    except KeyError:
        raise ValueError(f"unknown sharding strategy {strategy!r}; "
                         f"known: {sorted(set(STRATEGIES))}") from None


# ---------------------------------------------------------------------------
# Placement engine
# ---------------------------------------------------------------------------
class _Placer:
    """Greedy axis placement with divisibility + single-use enforcement.

    ``place(axis, dim_prefs)`` walks the preference list and assigns ``axis``
    to the first dim whose size is divisible by the product of the axes
    already on that dim times ``axis``'s size.  An axis is used at most once
    across the whole spec; failure to place simply replicates (the
    "replicate-on-indivisible" rule).
    """

    def __init__(self, shape: Sequence[int], sizes: Dict[str, int]):
        self.shape = tuple(int(s) for s in shape)
        self.sizes = sizes
        self.dims: List[List[str]] = [[] for _ in self.shape]
        self.used: set = set()

    def place(self, axis: str, dim_prefs: Sequence[int]) -> Optional[int]:
        if axis not in self.sizes or axis in self.used:
            return None
        for d in dim_prefs:
            if d < 0 or d >= len(self.shape):
                continue
            need = _prod(self.sizes[a] for a in self.dims[d])
            need *= self.sizes[axis]
            if self.shape[d] > 0 and self.shape[d] % need == 0:
                self.dims[d].append(axis)
                self.used.add(axis)
                return d
        return None

    def entries(self) -> List[Any]:
        out: List[Any] = []
        for axes in self.dims:
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(tuple(axes))
        return out


def _derive(shape, sizes, plan, contraction_dims) -> P:
    """Run a placement plan and build the spec.  RULE ZERO lives HERE: any
    data-parallel axis that a plan tried to put on a contraction dim is
    stripped before the spec is built — no individual rule can override it.
    """
    placer = _Placer(shape, sizes)
    for axis, dim_prefs in plan:
        safe = [d for d in dim_prefs
                if not (axis in DP_AXES and d in contraction_dims)]
        placer.place(axis, safe)
    for d in contraction_dims:                   # central backstop
        if 0 <= d < len(placer.dims):
            placer.dims[d] = [a for a in placer.dims[d] if a not in DP_AXES]
    return P(*placer.entries())


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def _linear_name(path: Tuple[str, ...]) -> str:
    leaf = path[-1]
    if leaf in ("w", "wc", "b") and len(path) >= 2:
        return path[-2]
    if (leaf in SPECTRAL_PLANES or leaf in SPECTRAL_SCALES) and len(path) >= 2:
        parent = path[-2]
        if parent == "wc_cache" and len(path) >= 3:
            return path[-3]                  # e.g. o/wc_cache/wr -> "o" (row)
        if parent.endswith("_cache"):
            return parent[:-len("_cache")]   # qkv/upgate/up/gate/down
    return leaf


def _param_core_spec(path, core, sizes, strategy) -> P:
    """Spec for the unstacked core shape of one parameter leaf."""
    leaf = path[-1]
    row = _linear_name(path) in ROW_LINEAR
    tp = strategy != "tokenpar"                  # tokenpar replicates weights
                                                 # over the model axis

    if leaf == "table":                          # embedding / tied LM head:
        plan = []                                # vocab over model (+FSDP)
        if tp:
            plan.append((MODEL_AXIS, [0]))
        plan.extend((a, [0]) for a in DP_AXES)
        return _derive(core, sizes, plan, contraction_dims=())

    # per-block-row quantization scales (p, 1) / expert (E, p, 1): the
    # block-row dim carries "model" exactly when the payload's does
    # (column TP; expert scales follow the EP-first preference); size-1
    # dims never place, and DP axes are skipped — a replicated scale is
    # free next to its k-times-larger payload.  Checked BEFORE the experts
    # branch: an (E, p, 1) scale must not be specced as a dense
    # (E, n_in, n_out) expert weight.
    if leaf in SPECTRAL_SCALES and len(core) in (2, 3):
        if len(core) == 3:                       # (E, p, 1) expert scales
            prefs = [0] + ([] if row else [1])
        else:                                    # (p, 1)
            prefs = [] if row else [0]
        plan = [(MODEL_AXIS, prefs)] if tp else []
        return _derive(core, sizes, plan, contraction_dims=())

    if "experts" in path:                        # (E, ...) per-expert stacks
        nd = len(core)
        if nd == 4:                              # circulant (E, p, q, k)
            e_dim, p_dim, q_dim, k_dim = 0, 1, 2, 3
        elif nd == 3:                            # dense (E, n_in, n_out)
            e_dim, p_dim, q_dim, k_dim = 0, 2, 1, -1
        else:                                    # router-ish oddity: replicate
            return P()
        contraction = (q_dim,)
        # EP when E divides the model axis; else TP inside the expert.
        intra = [q_dim, k_dim] if row else [p_dim, k_dim]
        plan = []
        if tp:
            plan.append((MODEL_AXIS, [e_dim] + intra))
        plan.extend((a, [k_dim, p_dim]) for a in DP_AXES)
        return _derive(core, sizes, plan, contraction_dims=contraction)

    # block-circulant generators (p, q, k) and their spectral serving planes
    # (p, q, kf) place identically: the frequency dim simply fails DP
    # divisibility more often (kf = k/2+1 is odd) and falls back to p.
    if (leaf == "wc" or leaf in SPECTRAL_PLANES) and len(core) == 3:
        contraction = (1,)                       # q = input (contraction) blocks
        model_pref = [1, 2] if row else [0, 2]
        plan = []
        if tp:
            plan.append((MODEL_AXIS, model_pref))
        plan.extend((a, [2, 0]) for a in DP_AXES)
        return _derive(core, sizes, plan, contraction_dims=contraction)

    if len(core) == 2:                           # dense (n_in, n_out)
        contraction = (0,)
        model_pref = [0, 1] if row else [1]
        plan = []
        if tp:
            plan.append((MODEL_AXIS, model_pref))
        plan.extend((a, [1]) for a in DP_AXES)
        return _derive(core, sizes, plan, contraction_dims=contraction)

    # Unclassified multi-dim leaf: replicate (correct, never wrong — the
    # hill-climb loop promotes hot ones into explicit rules).
    return P()


def param_spec(path: Sequence[Any], shape: Sequence[int], mesh,
               strategy: str = "2d", stacked: Optional[bool] = None) -> P:
    """PartitionSpec for one parameter from its pytree path + shape.

    ``path`` is a tuple of pytree keys (strings or indices); ``shape`` the
    leaf shape.  Stacked/scanned leading dims (params under ``segments`` /
    ``enc_blocks`` / ``dec_blocks``) are detected and never sharded;
    ``stacked=False`` says the path has none (the port's modules, whose
    ``enc_blocks.<i>`` is one layer).
    """
    strategy = _canon_strategy(strategy)
    path = tuple(str(c) for c in path)
    shape = tuple(int(s) for s in shape)
    sizes = axis_sizes(mesh)
    leaf = path[-1] if path else ""

    if leaf in REPLICATED_LEAVES:
        return P()

    if stacked is None:
        stacked = bool(path and STACKED_ROOTS.intersection(path))
    n_stack = 1 if stacked else 0
    if leaf in _CORE_RANK:                       # rank-derived stack count
        rank = _CORE_RANK[leaf]
        if (leaf in SPECTRAL_PLANES or leaf in SPECTRAL_SCALES) \
                and "experts" in path:
            rank += 1            # (E, p, q, kf) expert planes / (E, p, 1)
        n_stack = max(n_stack, len(shape) - rank)
    n_stack = min(n_stack, len(shape))
    core = shape[n_stack:]

    if len(core) <= 1:                           # scalars, norms, biases
        return P()

    spec = _param_core_spec(path, core, sizes, strategy)
    if n_stack == 0:
        return spec
    return P(*([None] * n_stack), *tuple(spec))



_PLANE_LEAF = re.compile(r"^(.+_cache)_((?:wr|wi|ws1|ws2)(?:_s)?)$")


def module_path(name: str) -> Tuple[str, ...]:
    """A module name as ``repro``'s pytree path: dots split it, and a baked
    plane buffer ``<prefix>_cache_<plane>`` (``core/circulant.py:
    register_planes``) becomes ``("<prefix>_cache", "<plane>")``."""
    parts = name.split(".")
    m = _PLANE_LEAF.match(parts[-1])
    if m:
        parts[-1:] = [m.group(1), m.group(2)]
    return tuple(parts)


def _leaves(params) -> Dict[str, Any]:
    """name -> tensor (or shape) of a module's parameters and set buffers,
    or of a mapping as it stands."""
    if isinstance(params, torch.nn.Module):
        out = dict(params.named_parameters())
        out.update((n, b) for n, b in params.named_buffers() if b is not None)
        return out
    return dict(params)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def param_specs(params, mesh, strategy: str = "2d") -> Dict[str, P]:
    """``param_spec`` of every parameter and baked buffer of a module (or
    of a ``{name: tensor or shape}`` mapping), keyed by module name."""
    return {name: param_spec(module_path(name), _shape(leaf), mesh, strategy,
                             stacked=False)
            for name, leaf in _leaves(params).items()}


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_spec(shape: Sequence[int], mesh, global_batch: int,
               seq_shard: bool = False) -> P:
    """Spec for a batch-leading activation or input: batch dim over the DP
    axes (as a tuple, so 256- and 512-chip meshes read uniformly), optional
    sequence dim over "model" (token parallelism), replicate-on-indivisible.
    Dim 0 is only treated as the batch dim when it equals ``global_batch``
    (pass the leaf's own leading size for microbatched slices).
    """
    shape = tuple(int(s) for s in shape)
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    entries: List[Any] = [None] * len(shape)
    if (shape and dpa and shape[0] == int(global_batch)
            and shape[0] % _prod(sizes[a] for a in dpa) == 0):
        entries[0] = tuple(dpa)
    if (seq_shard and len(shape) >= 2 and MODEL_AXIS in sizes
            and shape[1] % sizes[MODEL_AXIS] == 0):
        entries[1] = MODEL_AXIS
    return P(*entries)


def batch_specs(batch, mesh, global_batch: int, seq_shard: bool = False):
    """``batch_spec`` mapped over a batch (dicts / lists of tensors)."""
    return _map_with_path(
        lambda _, leaf: batch_spec(_shape(leaf), mesh, global_batch,
                                   seq_shard=seq_shard), batch)


def cache_spec(path: Sequence[Any], shape: Sequence[int], dtype, mesh,
               global_batch: int) -> P:
    """Spec for one KV-cache / recurrent-state leaf.

    Integer leaves (ring positions, counters) replicate.  Float leaves shard
    their batch dim (first dim equal to ``global_batch``) over the DP axes;
    KV-shaped leaves ``(..., B, S, H, D)`` additionally put "model" on the
    heads dim when divisible, falling back to head_dim (GQA archs have too
    few KV heads for a 16-way model axis).  The sequence dim is NEVER sharded
    — decode writes single slots at dynamic positions.
    """
    shape = tuple(int(s) for s in shape)
    if _is_integer(dtype) or not shape:
        return P()
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    b_idx = next((i for i, s in enumerate(shape) if s == int(global_batch)),
                 None)
    if b_idx is None:
        return P()
    entries: List[Any] = [None] * len(shape)
    if dpa and shape[b_idx] % _prod(sizes[a] for a in dpa) == 0:
        entries[b_idx] = tuple(dpa)
    m = sizes.get(MODEL_AXIS)
    if m and len(shape) >= b_idx + 3:            # (..., B, S, H, D)-like tail
        if len(shape) - 2 > b_idx and shape[-2] % m == 0:
            entries[-2] = MODEL_AXIS
        elif shape[-1] % m == 0:
            entries[-1] = MODEL_AXIS
    return P(*entries)


def cache_specs(cache, mesh, global_batch: int):
    """``cache_spec`` mapped over a cache (the port's dicts and per-layer
    lists; a ring's host ``pos`` row is an integer leaf and replicates)."""
    return _map_with_path(
        lambda path, leaf: cache_spec(path, _shape(leaf),
                                      getattr(leaf, "dtype", torch.float32),
                                      mesh, global_batch), cache)


def page_pool_spec(shape: Sequence[int], mesh) -> P:
    """Spec for one paged KV-pool leaf ``(..., P, page, Hkv, D)``
    (serve/kvcache.py) — pages shard like the dense cache they replace:

    * the PAGE-ID dim takes the DP axes (each DP shard owns a slice of the
      free pool, the way the dense cache's batch dim spread requests over
      DP) when divisible, else replicates;
    * heads take "model" when divisible, falling back to head_dim (GQA
      archs have too few KV heads for a 16-way model axis) — identical to
      ``cache_spec``;
    * the in-page offset dim is NEVER sharded (decode writes single slots
      at dynamic offsets, same reason the dense sequence dim never shards);
    * extra leading dims are scan-stack dims, never sharded.
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) < 4:
        return P()
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    entries: List[Any] = [None] * len(shape)
    p_idx = len(shape) - 4
    if dpa and shape[p_idx] % _prod(sizes[a] for a in dpa) == 0:
        entries[p_idx] = tuple(dpa)
    m = sizes.get(MODEL_AXIS)
    if m:
        if shape[-2] % m == 0:
            entries[-2] = MODEL_AXIS
        elif shape[-1] % m == 0:
            entries[-1] = MODEL_AXIS
    return P(*entries)


def decode_head_spec(shape: Sequence[int], mesh) -> P:
    """Spec for per-slot decode-attention activations ``(B, Hq, D)`` — the
    q / output of the streamed paged-attention op (kernels/paged_attention).

    Slots take the DP axes (the dense batch dim's role), heads take "model"
    with a head-dim fallback — the SAME head placement ``page_pool_spec``
    gives the pool, so the streamed contraction shards head-aligned with
    the KV pages it reads and GSPMD inserts no resharding between them.
    Replicate-on-indivisible throughout (GQA archs with few heads).
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        return P()
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    entries: List[Any] = [None] * 3
    if dpa and shape[0] % _prod(sizes[a] for a in dpa) == 0:
        entries[0] = tuple(dpa)
    m = sizes.get(MODEL_AXIS)
    if m:
        if shape[1] % m == 0:
            entries[1] = MODEL_AXIS
        elif shape[2] % m == 0:
            entries[2] = MODEL_AXIS
    return P(*entries)


def dp_round_up(n: int, mesh) -> int:
    """Round a page count up to a multiple of the mesh's DP-axis product.

    ``page_pool_spec`` only shards the page dim when it divides the DP
    product; an off-by-one pool (e.g. the +1 trash page) would otherwise
    silently replicate the whole pool over the data-parallel devices.
    """
    sizes = axis_sizes(mesh)
    dp = _prod(sizes[a] for a in dp_axes(mesh)) or 1
    return -(-int(n) // dp) * dp


def page_scale_spec(shape: Sequence[int], mesh) -> P:
    """Spec for a paged-pool quantization-scale leaf ``(..., P, Hkv)``
    (serve/kvcache.py int8 pools: one f32 absmax scale per (page, head)).

    Scales shard LIKE THEIR PAYLOAD: the page-id dim takes the DP axes
    exactly as ``page_pool_spec`` places the pool's, and heads take
    "model" when divisible.  A scale has no in-page-offset dim at all —
    the per-page granularity is what keeps the offset axis unsharded by
    construction — and no head_dim, so the pool's head_dim fallback
    becomes replication here (free at this size).
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        return P()
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    entries: List[Any] = [None] * len(shape)
    p_idx = len(shape) - 2
    if dpa and shape[p_idx] % _prod(sizes[a] for a in dpa) == 0:
        entries[p_idx] = tuple(dpa)
    m = sizes.get(MODEL_AXIS)
    if m and shape[-1] % m == 0:
        entries[-1] = MODEL_AXIS
    return P(*entries)


def pool_specs(pool, mesh):
    """``page_pool_spec`` mapped over a paged pool; int8-pool scale leaves
    (``k_scale`` / ``v_scale``) take ``page_scale_spec``; block tables and
    other integer leaves replicate."""
    def one(path, leaf):
        shape = _shape(leaf)
        name = path[-1] if path else ""
        if name in POOL_SCALES:
            return page_scale_spec(shape, mesh)
        if name in ("k", "v"):                   # pool payloads shard by
            return page_pool_spec(shape, mesh)   # shape even when int8
        if _is_integer(getattr(leaf, "dtype", torch.float32)):
            return P()
        return page_pool_spec(shape, mesh)
    return _map_with_path(one, pool)


def logits_spec(mesh, global_batch: int, vocab: int) -> P:
    """Spec for (B, S, V) logits: batch over DP, vocab over "model" (the
    tied LM head is vocab-sharded column TP), seq replicated."""
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    b_entry = (tuple(dpa) if dpa and
               int(global_batch) % _prod(sizes[a] for a in dpa) == 0 else None)
    m = sizes.get(MODEL_AXIS)
    v_entry = MODEL_AXIS if m and int(vocab) % m == 0 else None
    return P(b_entry, None, v_entry)


# ---------------------------------------------------------------------------
# Mesh binding
# ---------------------------------------------------------------------------
def to_placements(spec: Sequence[Any], mesh) -> List[Any]:
    """A spec bound to a ``DeviceMesh``: for each mesh dim, ``Shard(d)``
    for the tensor dim ``d`` whose entry names its axis, else
    ``Replicate()`` (``torch.distributed.tensor``'s placements)."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def local_shape(shape: Sequence[int], spec: Sequence[Any], mesh
                ) -> Tuple[int, ...]:
    """The per-device shape of a leaf under ``spec``: each dim divided by
    the sizes of the axes on it (the rules place an axis only where it
    divides)."""
    sizes = axis_sizes(mesh)
    out = []
    for d, s in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(int(s) // _prod(sizes[a] for a in axes))
    return tuple(out)
