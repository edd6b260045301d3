#!/usr/bin/env python3
"""Price the port's telemetry plane on one CUDA card: tinyllama-1.1b's
``ContinuousEngine`` at its published widths and depth, three engines on
the same weights, as ``repro``'s ``obs_overhead`` bench runs them:

* ``disabled``: ``Obs(enabled=False)`` (counters only);
* ``no_capture``: ``Obs()`` with ``capture=False`` (traces, profiler
  spans, histograms; no numerics capture);
* ``enabled``: ``Obs()`` (all of it: the capture in the replayed step,
  the health folds, the int8 pool's scale read-back).

    python3 tools/obs_overhead.py [--lanes int8,f32] [--rounds 12] \\
        [--requests 16] [--new-tokens 32] [--out FILE]

A lane is the serving policy: ``int8`` int8 planes and an int8 pool (what
``chip_smoke.py``'s ``serve_obs`` runs), ``f32`` float32 planes and pool
(no scale read-back).  Each engine serves a warm-up, then ``--rounds``
drains of the same ``--requests`` (17-200 prompt tokens, random from the
seed; 8 slots, pages of 16, chunks of 8), the arms' order rotated each
round.  The arms' tokens must be equal within a round (each engine has
its own pool and the same history; an int8 page recycled from an earlier
request keeps its grown scale, so tokens are compared at equal history).
Per lane and arm: drain seconds, tokens/s (median drain), ms a decode
step and a prefill (the engine's own ``decode_s`` / ``prefill_s``
counters over the rounds), and the host ms a decode dispatch spends in
the engine's obs block (``_observe_decode``); per lane the median and
quartiles of the per-round ratios enabled / disabled and enabled /
no_capture, and in how many rounds the enabled arm was slower.  Prints
one JSON line a lane, then the card's name and power limit.  Exits 2
without a CUDA device.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH, SEED, DEVICE = "tinyllama-1.1b", 0, "cuda"
ARMS = ("disabled", "no_capture", "enabled")


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def requests(cfg, n, new, rng):
    from repro_torch.serve.engine import Request
    lens = rng.randint(17, 201, size=n)
    return [Request(prompt=rng.randint(0, cfg.vocab_size, size=int(s))
                    .astype(np.int32), max_new_tokens=new, id=i)
            for i, s in enumerate(lens)]


def lane_run(lane, rounds, n_requests, new_tokens):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import init_params
    from repro_torch.obs import Obs
    from repro_torch.quant.codec import QuantPolicy
    from repro_torch.serve.engine import ContinuousEngine
    cfg = get_config(ARCH)
    policy = (QuantPolicy("int8", quant_weights=True) if lane == "int8"
              else QuantPolicy())
    params = init_params(cfg, seed=SEED, device=DEVICE)
    host = {}                       # engine id -> [seconds, dispatches]
    observe = ContinuousEngine._observe_decode

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        observe(self, *a, **k)
        acc = host.setdefault(id(self), [0.0, 0])
        acc[0] += time.perf_counter() - t0
        acc[1] += 1

    ContinuousEngine._observe_decode = timed
    try:
        obs = {"disabled": Obs(enabled=False), "no_capture": Obs(),
               "enabled": Obs()}
        engines = {arm: ContinuousEngine(
            cfg, params, max_slots=8, max_seq=256, page_size=16,
            decode_chunk=8, quant=policy, obs=obs[arm], device=DEVICE,
            capture=False if arm == "no_capture" else None)
            for arm in ARMS}
        rng = np.random.RandomState(SEED)
        warm = requests(cfg, 2, 4, rng)
        reqs = requests(cfg, n_requests, new_tokens, rng)
        for e in engines.values():
            e.generate(warm)
        before = {arm: e.stats() for arm, e in engines.items()}
        host.clear()
        secs = {arm: [] for arm in ARMS}
        tokens = 0
        for r in range(rounds):
            got = {}
            for arm in ARMS[r % 3:] + ARMS[:r % 3]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = engines[arm].generate(reqs)
                torch.cuda.synchronize()
                secs[arm].append(time.perf_counter() - t0)
                got[arm] = [x["tokens"] for x in res]
                tokens = sum(x["decode_len"] for x in res)
            if got["enabled"] != got["disabled"] or (
                    got["no_capture"] != got["disabled"]):
                raise AssertionError(f"{lane}: round {r}: tokens differ")
    finally:
        ContinuousEngine._observe_decode = observe
    arms = {}
    for arm, e in engines.items():
        st, b = e.stats(), before[arm]
        steps = st["decode_steps"] - b["decode_steps"]
        pre = st["prefills"] - b["prefills"]
        acc = host.get(id(e), [0.0, 0])
        arms[arm] = {
            "seconds": secs[arm],
            "tokens_per_s_median": tokens / statistics.median(secs[arm]),
            "tokens_per_s_best": tokens / min(secs[arm]),
            "ms_per_decode_step": 1e3 * (st["decode_s"] - b["decode_s"])
            / max(steps, 1),
            "ms_per_prefill": 1e3 * (st["prefill_s"] - b["prefill_s"])
            / max(pre, 1),
            "obs_host_ms_per_dispatch": (1e3 * acc[0] / acc[1]
                                         if acc[1] else 0.0),
            "decode_graphs": st["decode_graphs"]}
    ratio = [e / d for e, d in zip(secs["enabled"], secs["disabled"])]
    hratio = [e / n for e, n in zip(secs["enabled"], secs["no_capture"])]
    return {"lane": lane, "arch": ARCH, "requests": n_requests,
            "new_tokens": new_tokens, "tokens": tokens, "rounds": rounds,
            "quant_policy": policy.describe(), "arms": arms,
            "overhead_frac_quartiles": [x - 1 for x in quartiles(ratio)],
            "health_capture_frac_quartiles": [x - 1
                                              for x in quartiles(hratio)],
            "enabled_slower_rounds": sum(x > 1 for x in ratio)}


def main() -> int:
    if not torch.cuda.is_available():
        print("obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="int8,f32")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build()
    lines = []
    for lane in args.lanes.split(","):
        out = lane_run(lane, args.rounds, args.requests, args.new_tokens)
        print(json.dumps(out), flush=True)
        lines.append(out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
