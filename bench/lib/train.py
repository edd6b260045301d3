"""A training cell: ``repro_torch.train.train_step.make_train_step``'s step
over packed synthetic documents, timed by the host's clock around whole
steps (each ends in the host read of its loss, as a trainer logs it).

Set-up builds one training state (the benchmark's weights from the seed,
AdamW's zero moments) and one step, drives the first ``checked_steps``
steps through that step with batches that all differ, and keeps what the
check compares: each step's loss, the first gradient as AdamW got it
(its first moment after step 1 over ``1 - b1``), and the parameters'
change after the checked steps; then the same state and step run the
window.  A traced run profiles ``trace.steps`` whole steps of the window.

Mix keys: ``batch`` and ``seq`` (tokens a row), ``documents`` (a length
distribution, as a serving mix's ``prompt``) and ``docs`` (how many
lengths the set holds): each row packs documents of those lengths, in
the seed's order, each ended by the configuration's ``eos_token_id``, and
the labels are the next tokens; ``optimizer`` (``AdamWConfig``'s
fields); ``checked_steps``; ``trace``.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from . import devtrace, model, traffic
from .serve import log


def leaf_of(name: str) -> str:
    """A parameter's leaf: its path with the layer index dropped (every
    layer's tensor of one path is one leaf, as the optimizer stacks
    them)."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else name


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of every leaf over its layers' tensors."""
    sq: Dict[str, float] = {}
    for name, t in tensors.items():
        key = leaf_of(name)
        sq[key] = sq.get(key, 0.0) + float(torch.sum(t.double() ** 2))
    return {k: v ** 0.5 for k, v in sq.items()}


class Batches:
    """The mix's batches in the seed's order: rows of packed documents."""

    def __init__(self, mix: Dict, cfg: Dict, seed: int, device):
        self.B, self.S = int(mix["batch"]), int(mix["seq"])
        sizes = traffic.quantile_lengths(mix["documents"], int(mix["docs"]))
        self.rng = traffic.seed_rng(seed)
        self.lengths = sizes[self.rng.permutation(len(sizes))]
        self.next = 0
        self.vocab = cfg["vocab_size"]
        self.eos = int(cfg["eos_token_id"])
        self.device = device

    def __call__(self) -> Dict[str, torch.Tensor]:
        rows = np.empty((self.B, self.S + 1), np.int64)
        for b in range(self.B):
            fill = 0
            while fill < self.S + 1:
                n = int(self.lengths[self.next % len(self.lengths)])
                self.next += 1
                doc = self.rng.integers(0, self.vocab, size=n + 1)
                doc[-1] = self.eos
                take = min(n + 1, self.S + 1 - fill)
                rows[b, fill:fill + take] = doc[:take]
                fill += take
        t = torch.from_numpy(rows).to(self.device)
        return {"tokens": t[:, :-1].to(torch.int32).contiguous(),
                "labels": t[:, 1:].to(torch.int32).contiguous()}


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, clock0: float, sync) -> Dict:
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    arch = model.arch_config(cfg)
    arch = arch.replace(remat=cfg["training"]["remat"],
                        zloss=float(cfg["training"]["zloss"]))
    opt = adamw.AdamWConfig(**mix["optimizer"])
    weights = model.make_weights(cfg, seed, device)
    params = model.build_program_model(arch, weights, device)
    del weights
    state = ts.init_state(arch, opt, model=params)
    step = ts.make_train_step(arch, opt)
    batches = Batches(mix, cfg, seed, device)
    names = {id(p): n for n, p in params.named_parameters()}
    sync()
    log(f"state at {time.perf_counter() - clock0:.2f} s")
    losses: List[float] = []
    grad_norms = None
    for i in range(int(mix["checked_steps"])):
        state, metrics = step(state, batches())
        losses.append(float(metrics["loss"]))
        if i == 0:
            moments = {}
            for leaf, mv in zip(ts.state_leaves(state, arch),
                                state["opt"]["mv"]):
                for t, m in zip(leaf.tensors, mv["m"]):
                    moments[names[id(t)]] = m / (1.0 - opt.b1)
            grad_norms = leaf_norms(moments)
            del moments
    w0 = model.make_weights(cfg, seed, device)
    change = leaf_norms({n: p.detach() - w0[n]
                         for n, p in params.named_parameters()})
    del w0
    sync()
    log(f"checked steps to {time.perf_counter() - clock0:.2f} s")
    if trace:
        devtrace.warm(device.type)
    tokens = batches.B * batches.S
    t_open = time.perf_counter()
    setup_s = t_open - clock0
    t_end = t_open + seconds
    spans = []                      # (start, end) of each window step
    slice_data, tracer, traced = None, None, 0
    want = int(mix.get("trace", {}).get("steps", 0)) if trace else 0
    while True:
        batch = batches()
        if want and tracer is None and len(spans) >= 1:
            sync()
            tracer = devtrace.Profiler(device.type)
            rf = torch.profiler.record_function(devtrace.SLICE)
            rf.__enter__()
            t_tr = time.perf_counter()
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        with torch.profiler.record_function("bench.step") if (
                tracer is not None and slice_data is None) else nullcontext():
            state, metrics = step(state, batch)
            float(metrics["loss"])
        t1 = time.perf_counter()
        spans.append((t0, t1))
        if tracer is not None and slice_data is None:
            traced += 1
            if traced >= want:
                sync()
                rf.__exit__(None, None, None)
                wall = time.perf_counter() - t_tr
                slice_data = tracer.stop() or {}
                slice_data.update(wall_s=wall, steps=traced)
    inside = [(a, b) for a, b in spans if b <= t_end]
    sync()
    log(f"window {time.perf_counter() - t_open:.2f} s: {len(spans)} steps, "
        f"{len(inside)} inside")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    record = {
        "kind": "train", "cfg": cfg, "mix": mix, "seed": seed,
        "setup_s": setup_s, "t_open": t_open, "t_close": t_end,
        "window_s": seconds, "steps": inside, "tokens_per_step": tokens,
        "losses": losses, "grad_norms": grad_norms, "change": change,
        "skipped": int(state["skipped"]), "slice": slice_data,
        "memory_peak_bytes": int(peak),
    }
    del state, step, params, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def reference_steps(ref, cfg: Dict, mix: Dict, seed: int, device,
                    round_to=None, rows=None) -> Dict:
    """The plain reference through the checked steps from the same
    weights and batches: each step's loss, the first clipped gradient's
    leaf norms, the change's leaf norms after the last step.  The
    calibration puts it in the program's place with ``round_to`` (the
    control) or with only the first ``rows`` rows of each batch (a fault:
    half the batch left out, the mean taken over the rest)."""
    o = mix["optimizer"]
    b1, b2, eps, lr = o["b1"], o["b2"], o["eps"], o["lr"]
    wd, clip = o["weight_decay"], o["grad_clip"]
    zloss = float(cfg["training"]["zloss"])
    w = model.make_weights(cfg, seed, device)
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    m = {n: torch.zeros_like(t) for n, t in w.items()}
    v = {n: torch.zeros_like(t) for n, t in w.items()}
    batches = Batches(mix, cfg, seed, device)
    losses, first = [], None
    with ref.exact_float32():
        for step in range(1, int(mix["checked_steps"]) + 1):
            b = batches()
            loss = ref.train_loss(p, cfg, b["tokens"][:rows].long(),
                                  b["labels"][:rows].long(), zloss, round_to)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            g = dict(zip(p, grads))
            gnorm = float(torch.sqrt(sum(torch.sum(x * x) for x in grads)))
            scale = min(1.0, clip / max(gnorm, 1e-12)) if clip else 1.0
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for n, t in p.items():
                    gi = g[n] * scale
                    m[n].mul_(b1).add_((1 - b1) * gi)
                    v[n].mul_(b2).add_((1 - b2) * gi * gi)
                    upd = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps)
                    # decay on every stacked per-layer tensor and every
                    # matrix; a top-level vector (the final norm) keeps
                    decay = wd if (n.startswith("blocks.") or t.dim() >= 2) \
                        else 0.0
                    t.sub_(lr * (upd + decay * t))
            if step == 1:
                first = leaf_norms({n: g[n] * scale for n in p})
            del grads, g, loss
    change = leaf_norms({n: p[n].detach() - w[n] for n in p})
    return {"losses": losses, "grad_norms": first, "change": change}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def verdict(rec: Dict, ref, limits: Dict, device) -> Dict:
    r = reference_steps(ref, rec["cfg"], rec["mix"], rec["seed"], device)
    return compare(rec, r, limits)


def numbers(rec: Dict, r: Dict) -> Dict[str, float]:
    """The program's readings against the reference's: the widest gap of
    a checked step's loss, and the worst leaf's gap of the first gradient
    and of the change.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move under AdamW by round-off alone:
    the change leaves them out."""
    med = float(np.median(list(r["grad_norms"].values())))
    moving = [k for k, x in r["grad_norms"].items() if x >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(rec["losses"],
                                                   r["losses"])),
        "first_grad_leaf_gap": leaf_gap(rec["grad_norms"], r["grad_norms"],
                                        list(r["grad_norms"])),
        "change_leaf_gap": leaf_gap(rec["change"], r["change"], moving),
        "skipped_steps": rec["skipped"],
    }


def compare(rec: Dict, r: Dict, limits: Dict) -> Dict:
    """The numbers the cell's limits name, each with its limit, and no
    skipped step; a reading without a limit (one that no control or
    fault separates from sound runs) is logged, not compared."""
    got = numbers(rec, r)
    checks = {k: {"value": v, "limit": limits[k], "rule": "<="}
              for k, v in got.items() if k in limits}
    checks["skipped_steps"] = {"value": got["skipped_steps"], "limit": 0,
                               "rule": "<="}
    for k, v in got.items():
        if k not in checks:
            log(f"{k} {v} (not compared)")
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    n = len(rec["steps"]) + len(rec["losses"])
    return {"correct": ok, "attempted": n, "failed": 0, "checks": checks}
