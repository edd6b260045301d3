"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its limits and its metrics are found by the names in ``BENCHMARK.json``
(``lib/spec.py``).  The run makes its weights and traffic from the seed,
warms up, opens a window of ``--seconds`` of steady load, then checks what
the timed path produced against the plain reference (``lib/check.py``).

With ``--trace 0`` the result's metrics are the cell's end-to-end ones;
with ``--trace 1`` its per-layer ones, read from a profiled slice of the
window.  The last line of standard output is one JSON object; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key.  Without a CUDA device, or with fewer than the cell
asks for, it exits 2 and prints no result; with ``jax``, ``jaxlib``,
``flax`` or ``repro`` loaded once the window has closed, it exits 3.
"""
import time

CLOCK0 = time.perf_counter()            # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(argv=None, device=None, root=ROOT, clock0=CLOCK0):
    """One run; returns (exit code, result dict or None).  ``device`` None
    takes the card and refuses to run without one; a test passes a CPU
    device."""
    import torch

    from bench.lib import check, serve, spec as spec_lib

    args = parse(argv)
    serve.log(f"imports at {time.perf_counter() - clock0:.2f} s")
    spec = spec_lib.Spec(root)
    wl = spec.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: nothing measured", file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < int(wl["chips"]):
            print(f"{wl['name']} needs {wl['chips']} CUDA devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
        torch.cuda.init()
        serve.log(f"CUDA at {time.perf_counter() - clock0:.2f} s")
        # every library the port has, built together in a checkout's first
        # run and found built after it: no build lands in the ramp or window
        from repro_torch.kernels import build as kernel_build
        nvcc_s = sum(kernel_build.build().values())
        serve.log(f"kernels at {time.perf_counter() - clock0:.2f} s "
                  f"({nvcc_s:.1f} s of nvcc)")
    if device.type == "cuda":
        sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    else:
        sync = lambda: None  # noqa: E731
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    limits = spec.cell(wl["name"])
    if mix["kind"] == "serve":
        rec = serve.run(cfg, mix, args.seed, args.seconds, bool(args.trace),
                        device, clock0, sync)
        verdict = check.serve_verdict(rec, spec.reference(cfg), limits,
                                      device)
    else:
        from bench.lib import train
        rec = train.run(cfg, mix, args.seed, args.seconds, bool(args.trace),
                        device, clock0, sync)
        verdict = train.verdict(rec, spec.reference(cfg), limits, device)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()   # the engine's one rank
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3, None
    section = "per_layer" if args.trace else "end_to_end"
    metrics = spec_lib.read_metrics(spec, wl["name"], section, rec)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    sl = rec.get("slice")
    if args.trace and sl and sl.get("busy_s"):
        dev["busy_s"] = sl["busy_s"]
        dev["window_s"] = sl["slice_s"]
        result["breakdown"] = {"device_ops": sl["device_ops"],
                               "idle_gaps": sl["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is None:
        return code
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
