"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): trace every
(architecture x input-shape) cell's step against the production mesh with
NO device allocation, and report its per-device cost.

``repro`` lowers and compiles each cell with XLA against 256 or 512
virtual host devices.  The port traces it instead: a fake process group
of 256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``,
backend ``"fake"``: collectives return at once and move nothing) started
in this process, the (16, 16) or (2, 16, 16) mesh of
``launch/mesh.py:make_production_mesh`` over it, every parameter, batch
and cache leaf a ``DTensor`` with ``dist/sharding.py``'s placements over
a fake tensor on the CPU (``models/registry.py:input_specs``,
``abstract_params``), and the cell's step run once under
``roofline/analysis.py:StepCost``.  The layers run on ``DTensor``s
through the seams that ``dist/spmd.py:installed`` swaps in for the length
of the trace (the layers' own code has one path).

The trace takes the card's path, not the plain versions: inside
``kernels/standin.py:standin`` every kernel wrapper runs its card branch
on the fake tensors (its checks, its plan, its output and scratch
allocated) with its launch replaced by a stand-in that counts the launch
per lane, plan path and shape, as the card's counters do, and charges the
kernel's own FLOPs and bytes (each kernel module's ``work``: a DFT at 2.5
k log2 k, attention at 4 D a kept pair, K/V at their stored width).  So
a prefill's attention holds O(S) (the flash kernel's output and split
partials), not the plain version's S x S scores, and no ctypes kernel is
reached and nothing is computed.  What the card runs as plain PyTorch
stays plain in the trace: training attention (``masked_attention``, with
its S x S scores), the batch prefill's DFTs around ``spectral_matmul``,
the planes a training step derives per call.  A shape the card's kernel
refuses (a head dim the bf16 flash lane does not tile) fails the cell
with the kernel's error, as the card would.

The cells are ``repro``'s: a train cell steps ``AdamWConfig(
quantize_moments=True)`` with ``accum=4`` microbatches (``--roofline``:
``accum=0``, one batch, as ``repro``'s exact-cost lowering), through
``BCMatmulFFT`` (``bc_fused`` forward and adjoint, ``bc_grad_w``); a
prefill cell runs the batch engine's prefill step with its
``serve/engine.py:PrefillContract`` (the spectral MAC of each projection
through ``spectral_matmul`` where that kernel plans it, else through
``bc_fused``), and a decode cell its decode step, against the baked
serving planes (``precompute_serving_params``), the decode at the
cache's last position (``cache_pos = seq_len - 1``: the port's dense read
stops at a host position where ``repro`` reads the whole cache under a
traced scalar).  The records carry ``repro``'s keys
(``roofline/analysis.py:cell_report``) on the ``h100`` spec, the
launches a device makes (``launches``: kernel -> lanes, paths, shapes),
a prefill's ``prefill_lanes`` (the contract's choice by plane shape) and,
where ``--batch`` cuts the shape's batch, ``reduced``; a cell that raises
is recorded as ``fail`` with its error and the run exits 1.

What ``repro``'s ``--roofline`` also changes (unrolled scans, single-chunk
attention and mLSTM) changes nothing in the port's trace: it already runs
every layer, every attention chunk and every scan step once each; only
``accum=0`` takes effect.

Usage (a fresh process: it starts its own process group):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun.json
  # a one-rank cell a card can hold, to check against it:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch tinyllama-1.1b --shape prefill_32k --mesh one --batch 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ALL_SHAPES, SHAPES_BY_NAME, cell_is_applicable
from ..configs.registry import ARCH_IDS, get_config
from ..core.circulant import read_planes
from ..dist import ctx as dist_ctx
from ..dist import sharding as sh
from ..dist import spmd
from ..kernels.standin import launch_counts, standin
from ..models import registry as mreg
from ..optim import adamw
from ..quant.codec import baked_caches
from ..roofline import analysis as roofline
from ..serve import decode as serve_decode
from ..serve import params as serve_params
from ..serve.engine import PrefillContract
from ..train import train_step as ts
from . import mesh as mesh_lib

MESH_NAMES = {False: "16x16", True: "2x16x16"}


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (rank 0),
    unless one of at least that many runs already.  ``DTensor``'s notes on
    the redistributions it takes (and the fake group's fallbacks) are
    silenced: they are the trace's own business."""
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore", module=r"torch\.distributed")
    warnings.filterwarnings("ignore", message=".*implicitly creating a "
                            "replicated DTensor.*")
    if dist.is_initialized():
        if dist.get_world_size() >= world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _placed(t, spec, mesh):
    """A fake tensor as the ``DTensor`` of ``spec`` over ``mesh``: its
    local shard built directly (nothing is split or copied)."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sh.local_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device=t.device)
    return DTensor.from_local(local, mesh, sh.to_placements(spec, mesh),
                              run_check=False)


def _place_tree(tree, specs, mesh, cache: bool = False):
    """``_placed`` over a batch or (``cache``) a cache tree; a cache's
    integer leaves (positions, ring rows) stay plain (replicated)."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh, cache)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s, mesh, cache)
                          for v, s in zip(tree, specs))
    if cache and not (tree.dtype.is_floating_point or tree.dtype.is_complex):
        return tree
    return _placed(tree, specs, mesh)


def place_params(model: torch.nn.Module, mesh, strategy: str,
                 grad: bool = False) -> torch.nn.Module:
    """Every parameter and set buffer of ``model`` as the ``DTensor`` of
    its ``param_specs`` entry, in place."""
    specs = sh.param_specs(model, mesh, strategy)
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        t = _placed(getattr(mod, leaf), spec, mesh)
        if isinstance(getattr(mod, leaf), torch.nn.Parameter):
            t = torch.nn.Parameter(t, requires_grad=grad)
        setattr(mod, leaf, t)
    return model


def state_specs_for(cfg, mesh, strategy, mode) -> Tuple[Dict, object]:
    """The train state over ``mesh`` (no allocation): the model's
    parameters placed by their specs, the AdamW moments (int8 / uint8,
    ``quantize_moments=True``) placed as their parameters (``repro``'s
    ``mv_spec``), scalar scales and counters replicated.  Returns (state,
    opt_cfg)."""
    opt_cfg = adamw.AdamWConfig(quantize_moments=True)
    with mode:
        model = place_params(mreg.abstract_params(cfg, mode), mesh,
                             strategy, grad=True)
        state = ts.init_state(cfg, opt_cfg, model=model)
    return state, opt_cfg


def _with_roofline_knobs(cfg, shape):
    """``repro``'s exact-cost lowering knobs (chunk sizes, unrolled scans),
    kept in the config the records name."""
    S = shape.seq_len
    return cfg.replace(unroll_scan=True, attn_q_chunk=max(S // 4, 1),
                       attn_kv_chunk=max(S, 1), mlstm_chunk=max(S, 1))


def lower_cell(arch_id: str, shape_name: str, mesh,
               strategy: str = "megatron", compress: bool = True,
               donate: bool = True, seq_shard=None, accum: int = 4,
               cfg_override=None, global_batch: Optional[int] = None):
    """Trace one cell's step.  Returns (record, meta): a
    ``roofline.StepRecord`` and ``{"cfg", "shape", "params"}`` (a prefill
    adds ``prefill_lanes``), or (None, {"skipped": why}) for a cell that
    does not apply.  ``donate`` is ``repro``'s: the state (train) or the
    cache (serve) is updated in place, its outputs alias its inputs.
    ``global_batch`` replaces the shape's (a cut)."""
    cfg = cfg_override or get_config(arch_id, compress=compress)
    shape = SHAPES_BY_NAME[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    if accum == 0:
        accum = 1
        cfg = _with_roofline_knobs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if seq_shard is None:
        seq_shard = strategy == "tokenpar" and shape.kind != "decode"
    mode = mreg.fake_mode()
    specs = mreg.input_specs(cfg, shape, mode)
    shapes_params = mreg.abstract_params(cfg, mode)
    with mode:
        if shape.kind == "train":
            state, opt_cfg = state_specs_for(cfg, mesh, strategy, mode)
            step = ts.make_train_step(cfg, opt_cfg, accum=accum)
            batch = _place_tree(specs["batch"], sh.batch_specs(
                specs["batch"], mesh, B, seq_shard), mesh)
            args = (state, batch)
            donated, model = state, state["model"]
        else:
            params = serve_params.precompute_serving_params(
                mreg.abstract_params(cfg, mode), cfg)
            params = place_params(params, mesh, strategy)
            cache = _place_tree(specs["cache"], sh.cache_specs(
                specs["cache"], mesh, B), mesh, cache=True)
            donated, model = cache, params
            if shape.kind == "prefill":
                batch = _place_tree(specs["batch"], sh.batch_specs(
                    specs["batch"], mesh, B, seq_shard), mesh)
                contract = PrefillContract()   # decides per local shape
                step = serve_decode.make_prefill_step(cfg,
                                                      kernel_fn=contract)
                args = (params, batch, cache)
            else:
                tokens = _placed(specs["tokens"], sh.batch_spec(
                    specs["tokens"].shape, mesh, B), mesh)
                dec = serve_decode.make_decode_step(cfg)
                args = (params, tokens, cache, specs["cache_pos"])
                step = lambda p, t, c, _pos: dec(p, t, c, S - 1)  # noqa
        with dist_ctx.activation_policy(mesh, seq_shard=seq_shard), \
                spmd.installed(model, cfg), roofline.StepCost() as cost, \
                standin(cost):
            cost.watch(_flat(args))
            out = step(*args)
            out_new = cost.live_bytes(out)
            launches = launch_counts()
        # a decode step's position is a host int here, an argument in
        # repro's program
        arg_bytes = cost.read_bytes() + (
            roofline.local_bytes(specs["cache_pos"])
            if shape.kind == "decode" else 0)
    alias = roofline.local_bytes(_flat(donated)) if donate else 0
    out_bytes = roofline.local_bytes(_flat(out))
    record = roofline.StepRecord(
        flops=cost.flops, bytes_accessed=cost.bytes_accessed,
        collectives=roofline.collective_bytes(cost),
        argument_bytes=arg_bytes, output_bytes=out_bytes,
        temp_bytes=max(cost.peak - out_new, 0), alias_bytes=alias,
        launches=launches)
    meta = {"cfg": cfg, "shape": shape, "params": shapes_params}
    if shape.kind == "prefill":
        meta["prefill_lanes"] = contract.report()
    return record, meta


def card_cell(arch_id: str, shape_name: str, *, accum: int = 4,
              cfg_override=None, global_batch: Optional[int] = None,
              device="cuda", seed: int = 0):
    """The step ``lower_cell`` traces, with real inputs on ``device`` (one
    rank, nothing sharded): random weights from ``seed`` (baked planes at
    serve), the train state of ``state_specs_for``'s optimizer, a zero
    cache, random tokens.  Returns (step, args, inputs): ``step(*args)``
    runs it; ``inputs`` is the bytes of what the step reads of ``args``
    (a serving step reads the planes its MAC takes, not the generators
    beside them), which a one-rank record's ``argument_bytes`` predicts.
    A check of a record against the card runs it (``chip_smoke.py``)."""
    cfg = cfg_override or get_config(arch_id)
    shape = SHAPES_BY_NAME[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    if accum == 0:
        accum = 1
    S = shape.seq_len
    gen = torch.Generator().manual_seed(seed)

    def real(tree):
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if tree.dtype.is_floating_point:
            return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
        return torch.randint(0, cfg.vocab_size, tuple(tree.shape),
                             generator=gen, dtype=tree.dtype).to(device)
    specs = mreg.input_specs(cfg, shape)
    model = mreg.init_params(cfg, seed=seed, device=device)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(quantize_moments=True)
        state = ts.init_state(cfg, opt_cfg, model=model)
        args = (state, real(specs["batch"]))
        return (ts.make_train_step(cfg, opt_cfg, accum=accum), args,
                roofline.local_bytes(_flat(args)))
    params = serve_params.precompute_serving_params(model, cfg)
    cache = mreg.build_model(cfg).init_cache(shape.global_batch, S,
                                             device=device)
    read, replaced = 0, set()
    for _, m, prefix, baked in baked_caches(params):
        read += roofline.local_bytes(list(read_planes(
            baked, cfg.compression.gauss_trick).values()))
        gen_leaf = getattr(m, prefix[:-len("_cache")], None)
        if isinstance(gen_leaf, torch.Tensor):
            replaced.add(id(gen_leaf))
    read += sum(roofline.local_bytes(p) for p in params.parameters()
                if id(p) not in replaced)
    read += roofline.local_bytes(_flat(cache))
    if shape.kind == "prefill":
        batch = real(specs["batch"])
        step = serve_decode.make_prefill_step(cfg,
                                              kernel_fn=PrefillContract())
        return (step, (params, batch, cache),
                read + roofline.local_bytes(_flat(batch)))
    tokens = real(specs["tokens"])
    dec = serve_decode.make_decode_step(cfg)
    return (lambda p, t, c: dec(p, t, c, S - 1), (params, tokens, cache),
            read + roofline.local_bytes(tokens)
            + roofline.local_bytes(specs["cache_pos"]))


def _flat(tree):
    """A step's arguments or outputs as nested lists of tensors: a module
    as its parameters and set buffers (the baked planes)."""
    if isinstance(tree, (tuple, list)):
        return [_flat(o) for o in tree]
    if isinstance(tree, dict):
        return [_flat(v) for v in tree.values()]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    return tree


def run_cell(arch_id, shape_name, mesh, mesh_name, strategy, compress=True,
             accum=4, batch=None):
    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "strategy": strategy, "compress": compress,
           "lowering": "roofline" if accum == 0 else "production"}
    full = SHAPES_BY_NAME[shape_name].global_batch
    if batch is not None and batch != full:
        rec["reduced"] = {"global_batch": {"from": full, "to": int(batch)}}
    try:
        record, meta = lower_cell(arch_id, shape_name, mesh, strategy,
                                  compress, accum=accum,
                                  global_batch=batch)
        if record is None:
            rec["status"] = "skipped"
            rec["why"] = meta["skipped"]
            return rec
        rec.update(roofline.cell_report(record, meta["cfg"], meta["shape"],
                                        mesh, params=meta["params"]))
        if "prefill_lanes" in meta:
            rec["prefill_lanes"] = meta["prefill_lanes"]
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, continue the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _write(path: str, results) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "one"],
                    help="one: a 1-rank (1, 1) mesh (a cell that fits one "
                         "card, checked against it)")
    ap.add_argument("--strategy", default="megatron")
    ap.add_argument("--no-compress", action="store_true",
                    help="dense baseline (paper's uncompressed reference)")
    ap.add_argument("--roofline", action="store_true",
                    help="one batch, no microbatches (accum=0, as repro's "
                         "exact-cost lowering); its other knobs change "
                         "nothing in the port's trace")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut every shape's global batch to this (stated "
                         "in each record's 'reduced')")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True], "both": [False, True],
              "one": [None]}[args.mesh]
    start_fake_group(1 if args.mesh == "one" else
                     max(512 if m else 256 for m in meshes))

    results = []
    for multi in meshes:
        if multi is None:
            mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                      device="cpu")
            mname = "1x1"
        else:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi,
                                                 device="cpu")
            mname = MESH_NAMES[multi]
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mesh, mname, args.strategy,
                               compress=not args.no_compress,
                               accum=0 if args.roofline else 4,
                               batch=args.batch)
                status = rec["status"]
                extra = (rec.get("why") or rec.get("error", "")
                         if status != "ok" else
                         f"bytes/dev={rec['bytes_per_device']:.2e} "
                         f"flops/dev={rec['flops_per_device']:.3e}")
                print(f"[{mname}] {a} x {s}: {status} {extra}", flush=True)
                results.append(rec)
                if args.out:                    # incremental: survive kills
                    _write(args.out, results)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n== dry-run: {n_ok} ok / {n_skip} skipped / {n_fail} FAILED ==")
    if args.out:
        _write(args.out, results)
        print("wrote", args.out)
    dist.destroy_process_group()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
