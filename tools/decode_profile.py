#!/usr/bin/env python3
"""Time the continuous engine's paged decode loop of two source trees in
turns on one CUDA card, and read the device's idle share from a profile.

    python3 tools/decode_profile.py --parent DIR [--change DIR] \\
        [--order PCCP] [--archs tinyllama-1.1b,phi-3-vision-4.2b] \\
        [--engine paged|dense] [--out FILE]

Each turn is a fresh process started in the tree's root.  For each arch it
builds that tree's decode loop at the arch's published widths and depth
(random weights from a seed, float32 planes), then times it.

``--engine paged`` (the continuous engine's ``make_paged_decode_loop``): a
float32 pool of pages of 16, 8 slots filled by B=1 prefills of 17-200
tokens (``make_prefill_pack_step``, as the engine does; 4 slots for
phi-3-vision, whose prompts are 600-760 tokens long, and the other
archs; an arch with windowed layers has prompts of its largest window to
window + 104 tokens, so that they cover its ring caches), every
slot with a budget that outlasts the run; 2 warm-up dispatches of 8 steps
(a tree that captures its step does so in the first), 6 timed, 2
profiled.  ``--engine dense`` (the batch engine's ``make_decode_loop``):
the same number of rows, one batched prefill of the longest prompt length
(``make_prefill_step``, the spectral-MAC hook as the engine passes it),
then the loop of 16 steps against the float32 dense cache, once to warm
up, 3 times timed, once profiled.  Then:

* ``ms_per_step``: the timed steps, host clock;
* ``device_busy_ms_per_step``: 2 dispatches under ``torch.profiler``
  (CPU and CUDA activities), the union of the device's kernel and copy
  intervals a step;
* ``idle_share``: 1 - device_busy_ms_per_step / ms_per_step, the share of
  an unprofiled step's wall time in which the device runs nothing;
* ``idle_share_profiled``: the same over the profiled span (the first host
  event to the last device event), which the profiler's own host cost
  inflates: an upper bound.

Both trees' loops take ``loop(params, cur, pool, table, pos, rem)``, so
the same code runs either.  Prints one JSON line a turn and arch, and a
table; ``--out`` keeps the lines.  Exits 2 without a CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, sys, tempfile, time
from pathlib import Path
import numpy as np
import torch
sys.path.insert(0, "src")
if not torch.cuda.is_available():
    sys.exit(2)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
try:                        # any arch, the encoder-decoder too
    from repro_torch.models.registry import init_params
except ImportError:         # trees that serve decoder LMs only
    from repro_torch.models.transformer import init_params
from repro_torch.models.transformer import layer_kinds, window_for
from repro_torch.serve import decode as dec
from repro_torch.serve import kvcache as kvc
from repro_torch.serve.engine import frontend_inputs
from repro_torch.serve.params import precompute_serving_params
build.build()
PAGE, CHUNK = 16, 8


def busy_share(trace):
    events = json.loads(Path(trace).read_text())["traceEvents"]
    dev, t0, t1 = [], None, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((a, b))
            t1 = b if t1 is None else max(t1, b)
        elif e.get("cat") == "cpu_op":
            t0 = a if t0 is None else min(t0, a)
    dev.sort()
    busy, end = 0.0, None
    for a, b in dev:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, t1 - t0, len(dev)


def paged(cfg, params, slots, lo, hi):
    # the paged loop over slots prefilled as the engine prefills them:
    # run(n) makes n dispatches of CHUNK steps and returns the steps
    maxp = kvc.pages_for(hi + 120, PAGE)
    pool = kvc.build_pool(cfg, slots * maxp + 1, PAGE, device="cuda")
    rng = np.random.RandomState(0)
    table = np.zeros((slots, maxp), np.int32)
    cur, pos, rem = (np.zeros(slots, np.int32) for _ in range(3))
    for b in range(slots):
        S = int(rng.randint(lo, hi + 1))
        table[b] = np.arange(1 + b * maxp, 1 + (b + 1) * maxp)
        n_pre = kvc.pages_for(S, PAGE)
        toks = np.zeros(n_pre * PAGE, np.int64)
        toks[:S] = rng.randint(0, cfg.vocab_size, size=S)
        with torch.no_grad():
            first, _, pool, _ = dec.make_prefill_pack_step(cfg, n_pre, PAGE)(
                params, {"tokens": torch.as_tensor(toks[None], device="cuda"),
                         **frontend_inputs(cfg, 1, "cuda")},
                pool, torch.as_tensor(table[b, :n_pre], dtype=torch.int64,
                                      device="cuda"), S)
        cur[b], pos[b], rem[b] = int(first), S, 1000
    loop = dec.make_paged_decode_loop(cfg, CHUNK)
    tab = torch.as_tensor(table, device="cuda")
    state = [torch.as_tensor(a, device="cuda") for a in (cur, pos, rem)]

    def run(n):
        steps = 0
        with torch.no_grad():
            for _ in range(n):
                out = loop(params, state[0], pool, tab, state[1], state[2])
                # the engine reads every output back after a dispatch
                [t.cpu() for t in (out[0], out[1], out[3], out[4], out[5],
                                   out[6])]
                state[:] = [out[1], out[3], out[4]]
                steps += out[7]
        return steps
    return run, loop


def dense(cfg, params, rows, lo, hi, steps=16):
    # the batch engine's loop: one prefill of rows prompts of hi tokens,
    # then steps tokens a row against the dense cache; run(n) runs the
    # loop n times from the same prefill and returns the steps
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(rows, hi)),
                           device="cuda")
    model = dec.build_model(cfg)
    cache = model.init_cache(rows, hi + steps - 1, dtype=torch.float32,
                             device="cuda")
    with torch.no_grad():
        logits, cache = dec.make_prefill_step(
            cfg, kernel_fn=kops.spectral_contract)(
            params, {"tokens": toks, **frontend_inputs(cfg, rows, "cuda")},
            cache)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    lengths = torch.full((rows,), steps, dtype=torch.int32, device="cuda")
    loop = dec.make_decode_loop(cfg, steps)

    def run(n):
        done = 0
        with torch.no_grad():
            for _ in range(n):
                buf, _, k = loop(params, first, cache, hi, lengths)
                buf.cpu()
                done += k
        return done
    return run, loop


engine = sys.argv[2]
for arch in sys.argv[1].split(","):
    cfg = get_config(arch)
    slots = 8 if arch == "tinyllama-1.1b" else 4
    # an arch with windowed layers (mixtral, gemma2, recurrentgemma): its
    # prompts cover the largest window (the ring rule)
    window = max(window_for(k, cfg) for k in layer_kinds(cfg))
    lo, hi = ((600, 760) if cfg.frontend == "vision_stub"
              else (window, window + 104) if window else (17, 200))
    params = precompute_serving_params(
        init_params(cfg, seed=0, device="cuda"), cfg)
    if engine == "paged":
        dispatches, loop = paged(cfg, params, slots, lo, hi)
        warm, timed, profiled = 2, 6, 2
    else:
        dispatches, loop = dense(cfg, params, slots, lo, hi)
        warm, timed, profiled = 1, 3, 1
    t0 = time.perf_counter()
    dispatches(warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = dispatches(timed)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        psteps = dispatches(profiled)
        torch.cuda.synchronize()
    trace = Path(tempfile.mkdtemp()) / "trace.json"
    prof.export_chrome_trace(str(trace))
    busy, span, n_dev = busy_share(trace)
    busy_ms = busy / 1e3 / psteps
    print(json.dumps({"arch": arch, "engine": engine, "rows": slots,
                      "steps": steps,
                      "ms_per_step": ms, "warm_s": warm_s,
                      "profiled_steps": psteps,
                      "device_busy_ms_per_step": busy_ms,
                      "span_ms_per_step": span / 1e3 / psteps,
                      "idle_share": 1 - busy_ms / ms,
                      "idle_share_profiled": 1 - busy / span,
                      "device_events": n_dev,
                      "captures": getattr(loop, "captures", 0)}), flush=True)
    del params, dispatches, loop, prof
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--archs", default="tinyllama-1.1b")
    ap.add_argument("--engine", choices=("paged", "dense"), default="paged")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    trees = {"P": args.parent.resolve(), "C": args.change.resolve()}
    kept = []
    for turn, tag in enumerate(args.order):
        proc = subprocess.run([sys.executable, "-c", TURN, args.archs,
                               args.engine],
                              cwd=trees[tag], capture_output=True, text=True)
        if proc.returncode == 2:
            print("decode_profile: no CUDA device", file=sys.stderr)
            return 2
        if proc.returncode != 0:
            print(f"turn {turn} ({tag}) failed, exit {proc.returncode}:\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                line = {"turn": turn, "tree": tag, **json.loads(ln)}
                kept.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in kept))
    print("arch engine turn tree ms_per_step device_busy_ms_per_step "
          "idle_share idle_share_profiled")
    for r in sorted(kept, key=lambda r: (r["arch"], r["turn"])):
        print(r["arch"], r["engine"], r["turn"], r["tree"],
              f"{r['ms_per_step']:.3f}",
              f"{r['device_busy_ms_per_step']:.3f}",
              f"{r['idle_share']:.4f}", f"{r['idle_share_profiled']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
