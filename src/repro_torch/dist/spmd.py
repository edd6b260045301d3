"""SPMD execution of the port's layers over ``DTensor`` parameters: what
the dry run (``launch/dryrun.py``) traces a step through.

The parameters carry ``dist/sharding.py``'s specs as ``DTensor``
placements (``sharding.to_placements``), the batch and cache theirs, and
the model's own code runs on them.  Elementwise operations, norms,
reductions, the tied head and the cache's slices follow ``DTensor``'s
sharding propagation; plain constants (positions, masks, the DFT
matrices) count as replicated (``implicit_replication``).  What
``DTensor`` cannot follow is a block-circulant projection: ``_blockify``
reshapes its input's feature dim into (q, k) blocks, which a sharded
feature dim does not survive.  So each projection runs on its local
shards (``projection``), the way Megatron splits a linear layer:

* the weight's placement on the ``"model"`` axis names its role: its
  output blocks (``p``; a dense weight's ``n_out``; an expert stack's
  experts) sharded is a column-parallel projection, whose output comes out
  sharded on its last dim (on its expert dim for a stack); its input
  blocks (``q``; a dense weight's ``n_in``) sharded is a row-parallel one,
  which takes its input sharded on the last dim and gives a ``Partial``
  sum, all-reduced at once as Megatron reduces it; any other
  placement (a block's ``k`` or ``kf`` dim, which no projection can split)
  is all-gathered before the call and the projection runs whole on every
  model rank;
* a weight's shards over the data-parallel axes (the rules' FSDP
  placements) are all-gathered before the call, as GSPMD gathers them;
* the input keeps its placements on the data-parallel axes.

A leaf keeps the placement its spec gives: a gather at a use is a
collective of that step (counted by ``roofline/analysis.py``), not a
change of layout.  Where a column-parallel output cannot stay sharded,
the activation moves, never the weight: a projection whose blocks pad
``n_out`` (``p k > n_out``) and a fused q/k/v or up/gate cache (one
projection of ``sum(p_i)`` output blocks, its rank shards crossing the
projections' bounds) run on each rank's own output blocks, and their
output is all-gathered over ``"model"`` before it is cut (the padding
dropped, the fused output split).  A row-parallel bias is added after the
all-reduce.  Fused generators (train mode: one leaf a projection) that
all shard whole output blocks run as Megatron's fused QKV, each output
sharded on its last dim.

Attention over a KV cache whose heads do not divide the model axis (GQA:
the cache's spec then shards its head dim) is read whole: ``attention``
runs the core on local query heads, with K/V gathered where their heads
do not divide the axis and each model rank's query heads reading their
own KV heads (a rank's coordinate picks them).

The layers know nothing of this.  ``installed(model, cfg)``, which the
dry run enters around its trace, swaps the layers' seams (module-level
functions such as ``core/circulant.py:apply_linear``,
``layers/attention.py:attend``, ``train/train_step.py:microbatches``,
``FusedProjections.fused``) for versions that take the shards above on
``DTensor``s and the plain function on plain tensors, and hooks the
q/k/v projections whose outputs are viewed as heads; it restores all of
it on exit.  Outside that block nothing here runs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

MODEL_AXIS = "model"


class _Times(threading.local):
    def __init__(self):
        self.n = 1


_TIMES = _Times()


@contextlib.contextmanager
def counted(n: int):
    """The operations run inside count ``n`` times in a traced step's cost
    (``roofline/analysis.py:StepCost``): a strictly sequential scan of
    identical steps is traced for one and counted for all of them."""
    old = _TIMES.n
    _TIMES.n = old * int(n)
    try:
        yield
    finally:
        _TIMES.n = old


def count_times() -> int:
    return _TIMES.n


def is_dtensor(t) -> bool:
    if t is None or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def model_size(mesh) -> int:
    d = _model_dim(mesh)
    return 1 if d is None else int(mesh.shape[d])


def model_coordinate(mesh) -> int:
    """This rank's coordinate on the model axis."""
    d = _model_dim(mesh)
    return 0 if d is None else int(mesh.get_local_rank(d))


def _shard_dim(t, mesh_dim: int) -> Optional[int]:
    """The tensor dim a DTensor is sharded on over ``mesh_dim`` (negative,
    counted from the end), or None."""
    from torch.distributed.tensor import Shard
    pl = t.placements[mesh_dim]
    if isinstance(pl, Shard):
        return pl.dim - t.dim()
    return None


def _to(t, placements):
    if t is None or not is_dtensor(t):
        return t
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _gathered(t, placements):
    """A weight ``t`` at ``placements`` that differ from its own only by
    Shard -> Replicate: each such mesh dim one all-gather of the local
    tensor over that axis (``repro``'s major-first nesting of a dim two
    axes shard, where a data-axis gather of a model-sharded dim gives the
    model shard at once; ``DTensor``'s mesh-order nesting would gather
    over both axes and slice).  Anything else is ``DTensor``'s
    redistribution."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(t) or tuple(t.placements) == tuple(placements):
        return t
    pairs = list(zip(t.placements, placements))
    if not all(a == b or (isinstance(a, Shard) and isinstance(b, Replicate))
               for a, b in pairs):
        return _to(t, placements)
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    mesh = t.device_mesh
    local = t.to_local()
    for i, (a, b) in enumerate(pairs):
        if a != b and mesh.shape[i] > 1:     # one rank's gather is itself
            local = gather(local, gather_dim=a.dim, group=(mesh, i))
    return _from_local(local, mesh, placements)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _from_local(t, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False)


def _weight_placements(t, mesh, role: str, dims: Dict[str, int]):
    """Placements of a weight-like leaf for one call: its own on the model
    axis where ``role`` keeps it (``dims[role]`` names the dim), else
    replicated; replicated on every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    md = _model_dim(mesh)
    out = [Replicate()] * mesh.ndim
    if md is not None and role in dims and dims[role] is not None:
        out[md] = Shard(t.dim() + dims[role])
    return out


def _x_placements(x, mesh, role: str, batch_dim: Optional[int] = 0):
    """Placements of a projection's input: its own on the data axes (where
    it is sharded on ``batch_dim``), and on the model axis the role's:
    sharded on the last dim for a row-parallel call, on the expert dim for
    an expert-parallel one, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    md = _model_dim(mesh)
    out = []
    for i, pl in enumerate(x.placements):
        if i == md:
            if role == "row":
                out.append(Shard(x.dim() - 1))
            elif role == "expert":
                out.append(Shard(0))
            else:
                out.append(Replicate())
        elif isinstance(pl, Shard) and (batch_dim is None
                                        or pl.dim == batch_dim % x.dim()):
            out.append(pl)
        else:
            out.append(Replicate())
    return out


def _out_placements(x_pl, mesh, role: str, out_dim: int):
    from torch.distributed.tensor import Partial, Replicate, Shard
    md = _model_dim(mesh)
    out = list(x_pl)
    if md is not None:
        out[md] = {"col": Shard(out_dim), "row": Partial(),
                   "expert": Shard(0)}.get(role, Replicate())
    return out


def _role(w, mesh, dims: Dict[str, int]) -> str:
    """The weight's role on the model axis: the key of ``dims`` whose dim
    it is sharded on, else ``"none"``."""
    md = _model_dim(mesh)
    if md is None or model_size(mesh) == 1:
        return "none"
    d = _shard_dim(w, md)
    for role, dim in dims.items():
        if dim is not None and d == dim:
            return role
    return "none"


# the block dims of a leaf: generators / planes (..., p, q, kf), dense
# weights (n_in, n_out), scales (..., p, 1), biases (n_out,)
_BC_DIMS = {"col": -3, "row": -2}
_DENSE_DIMS = {"col": -1, "row": -2}


def _leaf_dims(name: str, leaf, dense: bool, stack: bool):
    if name == "table":                             # (vocab, d): the head
        dims = {"col": -2, "row": -1}
    elif name.endswith("_s"):                       # (..., p, 1) scales
        dims = {"col": -2, "row": None}
    elif name == "b":
        dims = {"col": -1, "row": None}
    else:
        dims = dict(_DENSE_DIMS if dense else _BC_DIMS)
    if stack:
        dims["expert"] = -leaf.dim()
    return dims


def projection(fn: Callable, x, weights: Dict[str, torch.Tensor], *,
               dense: bool, n_out: int, k: int = 0, stack: bool = False):
    """``fn(x_local, weights_local, n_out_local)`` on each rank's shards
    (module docstring).  ``weights`` holds the call's leaves by name (a
    generator ``wc`` or dense ``w``, a bias ``b``, planes ``wr`` ... and
    scales ``wr_s`` ...); the first of ``wc``, ``w``, ``wr`` names the
    role.  A column-parallel call's output is sharded only where its
    blocks cover ``n_out`` exactly (``p k == n_out``), else the weight is
    gathered.  An expert stack (``stack``: weights (E, ...), x (E, C,
    n_in)) is expert-parallel where its experts are sharded."""
    mesh = x.device_mesh
    lead_name = next(n for n in ("wc", "w", "wr", "table") if n in weights)
    lead = weights[lead_name]
    dims = _leaf_dims(lead_name, lead, dense, stack)
    role = _role(lead, mesh, dims)
    tp = model_size(mesh)
    # the output blocks pad n_out: each rank's blocks whole, then the
    # activation gathered and cut
    padded = role == "col" and not dense and lead.shape[-3] * k != n_out
    weights = dict(weights)
    # a bias after the sum (row: it would be summed tp times) or the cut
    bias = weights.pop("b") if (role == "row" or padded) and \
        "b" in weights else None
    x_pl = _x_placements(x, mesh, role, batch_dim=1 if stack else 0)
    out_dim = 0 if role == "expert" else -1
    out_pl = _out_placements(x_pl, mesh, role, out_dim % x.dim())
    local = {}
    for name, t in weights.items():
        local[name] = _local(_gathered(t, _weight_placements(
            t, mesh, role, _leaf_dims(name, t, dense, stack))))
    n_local = n_out
    if role == "col":
        n_local = lead.shape[-3] // tp * k if padded else n_out // tp
    y = fn(_local(_to(x, x_pl)), local, n_local)
    out = _summed(_from_local(y, mesh, out_pl))
    if padded:
        out = model_whole(out)[..., :n_out]
    if bias is not None:
        out = out + replicated(bias).to(out.dtype)
    return out


def fused_columns(fn: Callable, x, ws: Sequence[torch.Tensor],
                  n_outs: Sequence[int], k: int):
    """``fn(x_local, [w_local], [n_local])`` -> the local outputs of
    projections of one input run as one, over generators ``ws`` ((p_i, q,
    k) each) that all shard whole output blocks over the model axis
    (``p_i k == n_out_i``): Megatron's fused QKV, each output sharded on
    its last dim.  None where one does not (the caller then runs each
    projection alone)."""
    mesh = x.device_mesh
    tp = model_size(mesh)
    role = "col" if tp > 1 else "none"
    if tp > 1 and not all(_role(w, mesh, _BC_DIMS) == "col"
                          and w.shape[-3] * k == n
                          for w, n in zip(ws, n_outs)):
        return None
    x_pl = _x_placements(x, mesh, role)
    out_pl = _out_placements(x_pl, mesh, role, x.dim() - 1)
    wl = [_local(_gathered(w, _weight_placements(w, mesh, role, _BC_DIMS)))
          for w in ws]
    ys = fn(_local(_to(x, x_pl)), wl, [n // tp for n in n_outs])
    return [_from_local(y, mesh, out_pl) for y in ys]


def _summed(t):
    """A ``Partial`` sum over the model axis reduced at once (an
    all-reduce), as Megatron reduces a row-parallel output; anything else
    as it is."""
    from torch.distributed.tensor import Partial, Replicate
    md = _model_dim(t.device_mesh)
    if md is None or not isinstance(t.placements[md], Partial):
        return t
    pl = list(t.placements)
    pl[md] = Replicate()
    return t.redistribute(t.device_mesh, pl)


def attention(fn: Callable, q, k, v, heads_dim: int = 2, **kw):
    """``fn(q, k, v, **kw)`` of an attention core on local heads: q, k, v
    (..., H, D) with heads on ``heads_dim``.  Query heads are sharded over
    the model axis where they divide it, K/V heads where they divide it
    and the queries' do; K/V are otherwise gathered, and each model rank's
    query heads read their own group's KV heads.  Batch placements on the
    data axes are kept (K/V take the query's).  Returns the output on the
    query's placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    md = _model_dim(mesh)
    tp = model_size(mesh)
    H, Hkv = q.shape[heads_dim], k.shape[heads_dim]
    q_pl = [pl if i != md and isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for i, pl in enumerate(q.placements)]
    kv_pl = list(q_pl)
    q_split = md is not None and tp > 1 and H % tp == 0
    kv_split = q_split and Hkv % tp == 0
    if q_split:
        q_pl[md] = Shard(heads_dim)
    if kv_split:
        kv_pl[md] = Shard(heads_dim)
    ql = _local(_to(q, q_pl))
    kl, vl = (_local(_to(_as_dt(t, mesh), kv_pl)) for t in (k, v))
    B = q.shape[0]
    for name, t in list(kw.items()):          # per-row positions: local rows
        if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == B:
            kw[name] = _local(_to(_as_dt(t, mesh), [
                pl if i != md else Replicate()
                for i, pl in enumerate(q_pl)]))
    if q_split and not kv_split:           # this rank's query heads' KV
        hl = H // tp
        group = H // Hkv
        c = model_coordinate(mesh)
        lo = (c * hl) // group
        n = max(1, hl // group)
        kl = kl.narrow(heads_dim, lo, n)
        vl = vl.narrow(heads_dim, lo, n)
    o = fn(ql, kl, vl, **kw)
    return _from_local(o, mesh, q_pl)


def heads(t, n_heads: int):
    """``t`` (..., n_heads * dh) ready to be viewed as (..., n_heads, dh):
    a last dim sharded over the model axis in pieces that are not whole
    heads is gathered first."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    md = _model_dim(mesh)
    if (md is None or _shard_dim(t, md) != -1
            or n_heads % model_size(mesh) == 0):
        return t
    return model_whole(t)


def pinned(t):
    """``t`` as it is, with its gradient brought back to ``t``'s placements
    before it flows on (a redistribution node that moves nothing
    forward): a merge of heads (..., H, dh) -> (..., H dh) whose gradient
    arrives sharded in pieces that are not whole heads needs it."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def model_whole(t):
    """``t`` with its model-axis shard gathered (its data-axis shards
    kept); a plain tensor as it is.  An argmax over a sharded vocab reads
    it so."""
    if not is_dtensor(t):
        return t
    md = _model_dim(t.device_mesh)
    if md is None:
        return t
    from torch.distributed.tensor import Replicate
    pl = list(t.placements)
    pl[md] = Replicate()
    return _to(t, pl)


def _as_dt(t, mesh):
    """A plain tensor beside DTensors as a replicated DTensor."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated(t):
    """``t`` with every mesh axis replicated (a gather where it is
    sharded); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return _gathered(t, [Replicate()] * t.device_mesh.ndim)


def local_rows(fn: Callable, *ts, rows: int = 1,
               out_dims: Sequence[int] = (0,)):
    """``fn`` on each data-parallel shard's rows: the first ``rows``
    tensors of ``ts`` keep their dim-0 shards over the data axes and are
    replicated on the model axis; the others are replicated (gathered
    where sharded; plain tensors and None pass as they are).  The outputs
    (a tensor or a tuple of tensors and tuples) come back sharded over
    those data axes on ``out_dims`` (one per output, or one for all)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ts[0].device_mesh
    md = _model_dim(mesh)

    def rows_of(t):                        # dim-0 data shards, else whole
        return [p if i != md and isinstance(p, Shard) and p.dim == 0
                else Replicate() for i, p in enumerate(t.placements)]
    pl = rows_of(ts[0])
    loc = [(_local(_to(t, rows_of(t))) if is_dtensor(t) else t) if i < rows
           else _local(replicated(t)) for i, t in enumerate(ts)]
    out = fn(*loc)
    outs = out if isinstance(out, tuple) else (out,)
    dims = (list(out_dims) if len(out_dims) == len(outs)
            else [out_dims[0]] * len(outs))

    def wrap(o, d):
        if isinstance(o, tuple):
            return tuple(wrap(e, d) for e in o)
        opl = [Shard(d) if isinstance(p, Shard) else p for p in pl]
        return _from_local(o, mesh, opl)
    res = [wrap(o, d) for o, d in zip(outs, dims)]
    return tuple(res) if isinstance(out, tuple) else res[0]


def vocab_embed(table, tokens, fn: Callable):
    """``fn(table_local, tokens_local)`` (the lookup) over a vocab-sharded
    table, Megatron's vocab-parallel embedding: each model rank looks up
    the tokens of its vocab range (others read row 0 and are zeroed) and
    the rows are summed over the model axis (a ``Partial`` sum).  The
    table's data-axis shards are gathered; tokens keep their rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tokens.device_mesh
    md = _model_dim(mesh)
    role = _role(table, mesh, {"col": -2})
    t_pl = [Replicate()] * mesh.ndim
    if role == "col":
        t_pl[md] = Shard(0)
    tl = _local(_gathered(table, t_pl))
    x_pl = _x_placements(tokens, mesh, "none")
    xl = _local(_to(tokens, x_pl))
    if role != "col":
        return _from_local(fn(tl, xl), mesh, x_pl)
    V = tl.shape[0]
    lo = model_coordinate(mesh) * V
    inside = (xl >= lo) & (xl < lo + V)
    rows = fn(tl, torch.where(inside, xl - lo, torch.zeros_like(xl)))
    rows = rows * inside[..., None].to(rows.dtype)
    out_pl = list(x_pl)
    out_pl[md] = Partial()
    return _summed(_from_local(rows, mesh, out_pl))


def expert_combine(ye, comb, fn: Callable):
    """``fn(ye_local, comb_local)`` of the MoE's combine on each data
    shard: ye (E, G cap, d) as the expert stack left it (experts sharded,
    a ``Partial`` sum, or whole on the model axis), comb (G, g, E, cap)
    with its groups over the data axes.  Expert-parallel ``ye`` reads its
    experts' slice of ``comb`` and gives a ``Partial`` sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ye.device_mesh
    md = _model_dim(mesh)
    c_pl = [pl if i != md and isinstance(pl, Shard) else Replicate()
            for i, pl in enumerate(comb.placements)]
    cl = _local(_to(comb, c_pl))
    y_pl = [pl if i != md else ye.placements[md]
            for i, pl in enumerate(_x_placements(ye, mesh, "none", 1))]
    ep = md is not None and isinstance(ye.placements[md], Shard)
    if md is not None and not ep and not isinstance(ye.placements[md],
                                                    Partial):
        y_pl[md] = Replicate()
    yl = _local(_to(ye, y_pl))
    if ep:
        n = yl.shape[0]
        cl = cl.narrow(2, model_coordinate(mesh) * n, n)
    out_pl = list(c_pl)
    if md is not None:
        out_pl[md] = (Partial() if ep or isinstance(ye.placements[md],
                                                    Partial)
                      else Replicate())
    return _summed(_from_local(fn(yl, cl), mesh, out_pl))


def vocab_lse_pick(logits, labels):
    """(log-sum-exp, the label's logit) over the last dim of float32
    logits (..., V) whose vocab may be sharded over the model axis (the
    tied head's output), labels (...): Megatron's vocab-parallel
    cross-entropy terms.  Each rank takes its rows' maximum over its vocab
    range, the maxima are reduced (an all-reduce of a float a row), then
    its sums of exp and its rows' label logits where the label is in its
    range, each a ``Partial`` sum reduced the same way.  The rows keep
    their other placements (batch over the data axes, sequence over the
    model axis under token parallelism)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    md = _model_dim(mesh)
    vd = logits.dim() - 1
    rows = [Replicate() if isinstance(pl, Partial) or (
        isinstance(pl, Shard) and pl.dim == vd) else pl
        for pl in logits.placements]
    split = md is not None and _shard_dim(logits, md) == -1
    l_pl = list(rows)
    if split:
        l_pl[md] = Shard(vd)
    ll = _local(_to(logits, l_pl))
    lab = _local(_to(_as_dt(labels, mesh), rows)).long()
    if not split:
        lse = torch.logsumexp(ll, dim=-1)
        pick = ll.gather(-1, lab[..., None])[..., 0]
        return _from_local(lse, mesh, rows), _from_local(pick, mesh, rows)

    def reduced(t, op):
        pl = list(rows)
        pl[md] = Partial(op)
        return _local(_to(_from_local(t, mesh, pl), rows))
    m = reduced(ll.detach().amax(-1), "max")
    s = reduced(torch.exp(ll - m[..., None]).sum(-1), "sum")
    V = ll.shape[-1]
    lo = model_coordinate(mesh) * V
    inside = (lab >= lo) & (lab < lo + V)
    idx = torch.where(inside, lab - lo, torch.zeros_like(lab))
    pick = reduced(ll.gather(-1, idx[..., None])[..., 0]
                   * inside.to(ll.dtype), "sum")
    return (_from_local(torch.log(s) + m, mesh, rows),
            _from_local(pick, mesh, rows))


# ---------------------------------------------------------------------------
# The layers' seams, swapped in by ``installed`` for the length of a trace
# ---------------------------------------------------------------------------
def _sharded_linear(plain):
    """``core/circulant.py:apply_linear``: the leaves the call reads (the
    baked planes at serve, else the generators or the dense weight; the
    bias) go to ``projection``."""
    from ..core.circulant import read_planes

    def apply_linear(params, x, spec, n_out, mode="serve", kernel_fn=None):
        if not is_dtensor(x):
            return plain(params, x, spec, n_out, mode, kernel_fn)
        cache = params.get("wc_cache") if mode != "train" else None
        if cache is not None:                   # the planes the MAC reads
            cache = read_planes(cache, spec.gauss)
        weights = dict(cache) if cache is not None else {
            n: params[n] for n in ("w", "wc") if n in params}
        if "b" in params:
            weights["b"] = params["b"]

        def local(xl, wl, n_local):
            pl = {n: t for n, t in wl.items() if n in ("w", "wc", "b")}
            if cache is not None:
                pl["wc_cache"] = {n: t for n, t in wl.items() if n in cache}
            return plain(pl, xl, spec, n_local, mode, kernel_fn)
        return projection(local, x, weights, dense=spec.kind == "dense",
                          n_out=n_out, k=spec.block_size)
    return apply_linear


def _sharded_fused(plain, head_dim: int):
    """``FusedProjections.fused``: a baked fused cache is one projection
    of ``sum(p_i)`` blocks, run on each rank's blocks, its output gathered
    and split (``projection``, ``model_whole``); separate generators
    (train mode) run as one where they all shard whole output blocks
    (``fused_columns``), else one projection at a time.  An attention's
    outputs are then made whole heads (``heads``)."""
    from ..core import circulant as cc
    from ..layers.attention import Attention

    def fused(self, x, mode="serve", kernel_fn=None):
        if not is_dtensor(x):
            return plain(self, x, mode, kernel_fn)
        lins = self.fused_linears()
        gauss, k = lins[0].spec.gauss, lins[0].spec.block_size
        n_outs = [m.n_out for m in lins]
        cache = self.fused_cache if mode != "train" else None
        if cache is not None:
            ps = [m.wc.shape[-3] for m in lins]
            y = model_whole(projection(
                lambda xl, wl, n: cc._spectral_linear(xl, wl, k, gauss, n,
                                                      kernel_fn),
                x, cc.read_planes(cache, gauss), dense=False,
                n_out=sum(ps) * k, k=k))
            offs = [sum(ps[:i]) * k for i in range(len(ps))]
            outs = [y[..., o:o + n] for o, n in zip(offs, n_outs)]
        else:
            outs = fused_columns(
                lambda xl, wl, nl: cc.bc_matmul_fused(
                    xl, wl, nl, mode, gauss=gauss, kernel_fn=kernel_fn),
                x, [m.wc for m in lins], n_outs, k)
            if outs is None:
                outs = [cc.apply_linear({"wc": m.wc}, x, m.spec, m.n_out,
                                        mode, kernel_fn) for m in lins]
        if isinstance(self, Attention):
            outs = [heads(t, n // head_dim) for t, n in zip(outs, n_outs)]
        return outs
    return fused


def _sharded_attend(plain):
    """``layers/attention.py:attend``: over each rank's heads."""
    def attend(q, k, v, **kw):
        if not is_dtensor(q):
            return plain(q, k, v, **kw)
        return attention(plain, q, k, v, **kw)
    return attend


def _sharded_masked(plain):
    """``layers/attention.py:masked_attention``: over each rank's heads,
    the positions on each data shard's rows."""
    def masked_attention(q, k, v, rows, kv_positions, **kw):
        if not is_dtensor(q):
            return plain(q, k, v, rows, kv_positions, **kw)
        return attention(plain, q, k, v, rows=rows,
                         kv_positions=kv_positions, **kw)
    return masked_attention


def _sharded_ring_read(plain):
    """``layers/attention.py:_ring_read``: the runs' K/V cut from the
    ring in its own (B, S, Hkv, D) layout, then ``attend`` on heads."""
    from ..layers import attention as at

    def _ring_read(q, cache, runs, softcap):
        if not is_dtensor(q):
            return plain(q, cache, runs, softcap)
        kr = torch.cat([cache["k"][:, a:b] for a, b in runs], dim=1)
        vr = torch.cat([cache["v"][:, a:b] for a, b in runs], dim=1)
        return at.attend(*at.kv_read(q, kr, vr), causal=False,
                         softcap=softcap).to(q.dtype)
    return _ring_read


def _filled_ring(plain):
    """``layers/attention.py:ring_runs`` on the trace's ring row, which
    holds no data: a ring filled in position order up to ``q_pos``, every
    slot the newest position of its residue, so the slots ``0 .. min(len,
    q_pos + 1)``, all inside the window (the ring is no longer than
    it)."""
    from torch._subclasses.fake_tensor import is_fake

    def ring_runs(pos, q_pos, window):
        if not (is_dtensor(pos) or is_fake(pos)):
            return plain(pos, q_pos, window)
        return [(0, min(pos.shape[0], q_pos + 1))]
    return ring_runs


def _sharded_embed(plain):
    """``layers/embeddings.py:embed``: vocab-parallel (``vocab_embed``)."""
    def embed(table, tokens, scale_by_dim=False):
        if not is_dtensor(tokens):
            return plain(table, tokens, scale_by_dim)
        t = vocab_embed(table, tokens, lambda tl, xl: tl[xl])
        return t * (table.shape[-1] ** 0.5) if scale_by_dim else t
    return embed


def _sharded_logits(plain):
    """``layers/embeddings.py:logits``: the tied head a column-parallel
    weight (vocab sharded)."""
    def logits(table, x, softcap=0.0):
        if not is_dtensor(x):
            return plain(table, x, softcap)
        out = projection(lambda xl, wl, _: xl @ wl["table"].to(xl.dtype).T,
                         x, {"table": table}, dense=True,
                         n_out=table.shape[0])
        return softcap * torch.tanh(out / softcap) if softcap else out
    return logits


def _sharded_expert_ffn(plain):
    """``layers/ffn.py:_expert_ffn`` on ``DTensor`` stacks: each
    projection on its local shards (``projection``: expert-parallel where
    the experts are sharded over the model axis, else split inside the
    expert), the activation between them on ``DTensor``s."""
    from ..core import circulant as cc
    from ..kernels import ops as kops
    from ..layers import ffn

    def _expert_ffn(ex, xe, activation, d_ff, d_model, gauss, mode):
        if not is_dtensor(xe):
            return plain(ex, xe, activation, d_ff, d_model, gauss, mode)
        k = ex.block_size

        def proj(name, x, n_out):
            cache = ex.cache(name) if mode != "train" and k else None
            if cache is not None:            # the planes the MAC reads
                cache = cc.read_planes(cache, gauss)
            weights = (dict(cache) if cache is not None
                       else {"wc" if k else "w": getattr(ex, name)})

            def local(xl, wl, n_local):
                if not k:
                    return torch.einsum("ecd,edf->ecf", xl,
                                        wl["w"].to(xl.dtype))
                if cache is None and mode == "train":
                    return cc.bc_matmul_fft(xl, wl["wc"], n_local, gauss)
                planes = wl if cache is not None else cc.spectral_cache(
                    wl["wc"], gauss)
                return kops.bc_expert_linear(xl, planes, k, n_local, gauss)
            return projection(local, x, weights, dense=not k, n_out=n_out,
                              k=k, stack=True)

        h = ffn._act(activation, proj("gate", xe, d_ff)) * proj("up", xe,
                                                               d_ff)
        return proj("down", h, d_model)
    return _expert_ffn


def _sharded_moe(plain):
    """``layers/ffn.py:moe`` on ``DTensor``s: each data shard routes its
    own tokens (its routing groups formed from its rows: ``groups`` on the
    shard's token count) and dispatches them into the expert stack, which
    runs on its local shards; the combine reads each shard's own dispatch.
    Where the experts are sharded over the model axis the stack is
    expert-parallel and the combine a ``Partial`` sum (``expert_combine``).
    The router is a column-parallel projection whose logits are gathered
    over the model axis for the top-k.  ``logit_gap`` is not recorded."""
    from ..layers import ffn

    def moe(m, x, *, d_ff, moe_cfg, comp=None, activation="silu",
            mode="serve", kernel_fn=None):
        if not is_dtensor(x):
            return plain(m, x, d_ff=d_ff, moe_cfg=moe_cfg, comp=comp,
                         activation=activation, mode=mode,
                         kernel_fn=kernel_fn)
        E, topk = moe_cfg.num_experts, moe_cfg.top_k
        gauss = comp.gauss_trick if comp is not None else True
        S, d = x.shape[1], x.shape[-1]

        def dispatch(xl, ll):
            g, G, cap = ffn.groups(xl.shape[0] * S, S, moe_cfg, mode)
            xt = xl.reshape(G, g, d)
            disp, comb, gate_idx, logits = ffn.route_logits(
                ll.reshape(G, g, E), xt, E, topk, cap)
            xe = torch.einsum("gtd,gtec->gecd", xt, disp)
            xe = xe.transpose(0, 1).reshape(E, G * cap, d)
            aux = (ffn.load_balance(gate_idx, logits, E) if mode == "train"
                   else logits.new_zeros(()))
            return xe, comb, aux.reshape(1)

        def combine(yl, cl):
            G, g, _, cap = cl.shape
            yl = yl.reshape(yl.shape[0], G, cap, d).transpose(0, 1)
            return torch.einsum("gecd,gtec->gtd", yl, cl).reshape(-1, S, d)

        logits = model_whole(projection(
            lambda xl, wl, _: xl.float() @ wl["w"].float(), x,
            {"w": m.router}, dense=True, n_out=E))
        xe, comb, aux = local_rows(dispatch, x, logits, rows=2,
                                   out_dims=(1, 0, 0))
        ye = ffn._expert_ffn(m.experts, xe, activation, d_ff, d, gauss,
                             mode)
        out = expert_combine(ye, comb, combine)
        if m.shared is not None:
            out = out + ffn.mlp(m.shared, x, activation=activation,
                                mode=mode, kernel_fn=kernel_fn, comp=comp)
        return (out, aux.mean()) if mode == "train" else out
    return moe


def _on_rows(plain):
    """``plain`` on each data shard's rows: every tensor among its
    arguments (tuples of them included) sharded on dim 0 over the data
    axes, and so are its outputs (``local_rows``): the mLSTM's cores."""
    from torch.utils import _pytree as pytree

    def fn(*args, **kw):
        leaves, tree = pytree.tree_flatten((args, kw))
        at = [i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)]
        if not any(is_dtensor(leaves[i]) for i in at):
            return plain(*args, **kw)

        def body(*loc):
            new = list(leaves)
            for i, t in zip(at, loc):
                new[i] = t
            a, k = pytree.tree_unflatten(new, tree)
            return plain(*a, **k)
        return local_rows(body, *(leaves[i] for i in at), rows=len(at))
    return fn


def _sharded_scan(plain):
    """``layers/recurrent.py:slstm_scan`` on ``DTensor``s: each step's
    ``h @ wh`` a column-parallel projection (``projection``), the step's
    gates gathered over the model axis for the cell (``model_whole``),
    which runs on each data shard's rows (``local_rows``).  The first
    step is traced, the second traced and counted for the S - 1 alike
    steps (``counted``); h past them is the second's."""
    from ..layers import recurrent as rec

    def slstm_scan(gx, wh, b, state=None):
        if not is_dtensor(gx):
            return plain(gx, wh, b, state)
        S, d4 = gx.shape[1], gx.shape[-1]
        if state is None:
            state = local_rows(lambda g: tuple(rec.init_slstm_state(
                g.shape[0], d4 // 4, device=g.device)), gx)

        def step(g, st):
            hw = projection(lambda xl, wl, _: xl @ wl["w"], st[2],
                            {"w": wh}, dense=True, n_out=d4)
            return local_rows(lambda gl, *sl: rec.slstm_cell(gl, sl),
                              model_whole(g + hw + b), *st, rows=5)
        state = step(gx[:, 0], state)
        hs = [state[2][:, None]]
        if S > 1:
            with counted(S - 1):
                state = step(gx[:, 1], state)
            hs.append(state[2][:, None].expand(-1, S - 1, -1))
        return torch.cat(hs, dim=1), state
    return slstm_scan


def _sharded_cross_entropy(plain):
    """``train/train_step.py:cross_entropy`` in one chunk on ``DTensor``
    logits, vocab-parallel (``vocab_lse_pick``): each device holds its
    own rows."""
    def cross_entropy(logits, labels, zloss=0.0):
        if not is_dtensor(logits):
            return plain(logits, labels, zloss)
        lse, ll = vocab_lse_pick(logits.float(), labels)
        n = labels.numel()
        nll = (lse - ll).sum() / n
        return nll + zloss * (torch.square(lse).sum() / n) if zloss else nll
    return cross_entropy


def _counted_microbatches(plain):
    """``train/train_step.py:microbatches`` on a ``DTensor`` batch: each
    data shard's rows split n ways; the microbatches are alike, so one is
    traced, and the step's work on it (the loop body runs while this
    generator waits inside ``counted``) counts n times."""
    def microbatches(batch, n):
        if n <= 1 or not any(is_dtensor(v) for v in batch.values()):
            yield from plain(batch, n)
            return
        mb = {k: local_rows(
            lambda t: t.reshape(n, t.shape[0] // n, *t.shape[1:])[0], v)
            for k, v in batch.items()}
        with counted(n):
            yield mb
    return microbatches


def _gathered_greedy(plain):
    """``serve/decode.py:greedy`` over a vocab-sharded last dim: the
    logits gathered over the model axis first (``model_whole``)."""
    def greedy(logits):
        return plain(model_whole(logits))
    return greedy


@contextlib.contextmanager
def installed(model, cfg):
    """The layers on ``DTensor``s for the body of the block (module
    docstring): the seams swapped for the versions above (the mLSTM's
    ``head_rms``, a merge of heads, ``pinned``), the heads hooks on
    ``model``'s attention and mLSTM q/k/v projections, and plain tensors
    beside ``DTensor``s taken as replicated."""
    from ..core import circulant as cc
    from ..layers import attention as at
    from ..layers import embeddings as emb
    from ..layers import ffn
    from ..layers import recurrent as rec
    from ..serve import decode as dec
    from ..train import train_step as ts
    seams = ((cc, "apply_linear", _sharded_linear),
             (cc.FusedProjections, "fused",
              lambda f: _sharded_fused(f, cfg.attention.head_dim)),
             (at, "attend", _sharded_attend),
             (at, "masked_attention", _sharded_masked),
             (at, "_ring_read", _sharded_ring_read),
             (at, "ring_runs", _filled_ring),
             (emb, "embed", _sharded_embed),
             (emb, "logits", _sharded_logits),
             (ffn, "_expert_ffn", _sharded_expert_ffn),
             (ffn, "moe", _sharded_moe),
             (rec, "mlstm_seq", _on_rows),
             (rec, "mlstm_step", _on_rows),
             (rec, "head_rms", lambda plain: lambda h: pinned(plain(h))),
             (rec, "slstm_scan", _sharded_scan),
             (dec, "greedy", _gathered_greedy),
             (ts, "cross_entropy", _sharded_cross_entropy),
             (ts, "microbatches", _counted_microbatches))
    plain = [(obj, name, getattr(obj, name)) for obj, name, _ in seams]
    hooks = []
    try:
        for obj, name, make in seams:
            setattr(obj, name, make(getattr(obj, name)))
        for mod in model.modules():
            if isinstance(mod, at.Attention):
                n = cfg.attention.head_dim
            elif isinstance(mod, rec.MLSTMCell):
                n = mod.q.n_out // cfg.recurrent.mlstm_heads
            else:
                continue
            for lin in (mod.q, mod.k, mod.v):
                hooks.append(lin.register_forward_hook(
                    lambda m, _, out, n=n: heads(out, m.n_out // n)))
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            yield
    finally:
        for h in hooks:
            h.remove()
        for obj, name, fn in plain:
            setattr(obj, name, fn)
