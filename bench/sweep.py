"""Find the highest rate a serving cell's system sustains: its mix at each
of several open-loop rates, one line a rate.

    python3 bench/sweep.py --workload <cell> --rates 2.5,3,3.5,4 --seconds 30

For each rate, in one process: set-up, the mix's ramp and a window of
``--seconds`` with the mix's arrivals at that rate (requests a second),
then the rate of requests completed in the window, the engine's queue at
its end, the time to first token (median and 90th percentile), the 95th
percentile token gap and the tokens delivered a second.  A rate is
sustained where requests complete as fast as they arrive and the queue
does not grow.  A cell's rate is fixed in its mix at about four fifths of
the highest sustained rate (a cell above it measures throughput); no run
of the benchmark searches for it.  No check is made.
"""
import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def point(spec, workload: str, rate: float, seconds: float, seed: int,
          device, sync) -> dict:
    from bench.lib import serve, stats
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    mix = dict(mix, arrivals=dict(mix["arrivals"], rate=rate))
    rec = serve.run(cfg, mix, seed, seconds, False, device,
                    time.perf_counter(), sync)
    t0, t1 = rec["t_open"], rec["t_close"]
    done = [tr for tr in rec["finished"]]
    arrived = [tr for tr in rec["tracks"] if t0 <= tr.submit_t <= t1]
    ttft = stats.ttft_samples(rec["tracks"], t0, t1)
    gaps = [g for tr in rec["tracks"]
            for g in stats.token_gaps(tr.deliveries, t0, t1)]
    waiting = sum(1 for tr in rec["tracks"]
                  if tr.submit_t <= t1 and not tr.deliveries)
    tokens = sum(stats.tokens_in(tr.deliveries, t0, t1)
                 for tr in rec["tracks"])
    return {"workload": workload, "rate": rate,
            "arrived_per_s": len(arrived) / rec["window_s"],
            "completed_per_s": len(done) / rec["window_s"],
            "waiting_at_close": waiting,
            "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
            "itl_p95_ms": 1e3 * stats.percentile(gaps, 95),
            "output_tps": tokens / rec["window_s"]}


def main() -> int:
    import torch

    from bench.lib import spec as spec_lib
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = spec_lib.Spec(ROOT)
    for rate in map(float, args.rates.split(",")):
        out = point(spec, args.workload, rate, args.seconds, args.seed,
                    device, lambda: torch.cuda.synchronize(device))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
