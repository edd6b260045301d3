"""The readings a cell's limits are set from, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 40

For each seed, in one process: a run of the cell as ``bench/run.py``
makes it (set-up, ramp, a window of ``--seconds``), then the check's
sample judged twice: the program's served tokens against the float32
reference (the widest gap, as a run reads it), and the control, the
reference itself computed in float8 (``circulant_lm.fp8_rows``) in the
program's place, read at the same positions (the widest gap of the token
it puts first) and held to the cell's limit by the run's own verdict
(``check.serve_verdict(..., control=True)``: its ``correct`` has to come
out false).  One JSON line a seed.  The benchmark's runs never run the
control; a cell's limit lies between the largest program reading and the
smallest control reading (``PERF.md`` gives both).  A training cell
(``--seconds`` unused) reads its three checked steps, the control and
the fault of half the batch left out, each against the reference.
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


def readings(root, workload: str, seed: int, seconds: float, device,
             sync) -> dict:
    """The program's and the control's widest gap over one run's sample,
    and the run's verdict with the control in the program's place."""
    from bench.lib import check, serve
    from bench.lib import spec as spec_lib
    spec = spec_lib.Spec(root)
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    rec = serve.run(cfg, mix, seed, seconds, False, device,
                    time.perf_counter(), sync)
    picked = check.sample(rec, int(mix["check"]["requests"]))
    v = check.serve_verdict(rec, spec.reference(cfg), spec.cell(workload),
                            device, control=True)
    return {"workload": workload, "seed": seed,
            "program_gap": v["program_gap"],
            "control_gap": v["checks"]["max_logit_gap"]["value"],
            "judged_tokens": v["checks"]["judged_tokens"]["value"],
            "served": [len(tr.tokens) for tr in picked],
            "control_correct": v["correct"], "control_checks": v["checks"]}


def train_readings(root, workload: str, seed: int, device, sync) -> dict:
    """A training cell's numbers for the program (its checked steps), the
    control (the reference in float8 in its place) and the fault of half
    the batch left out (the reference on half the rows in its place),
    each against the float32 reference.  A state left unchanged reads 1
    on the change by the check's measure and needs no run."""
    from bench.lib import spec as spec_lib
    from bench.lib import train
    spec = spec_lib.Spec(root)
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    ref = spec.reference(cfg)
    rec = train.run(cfg, mix, seed, 0.0, False, device, time.perf_counter(),
                    sync)
    r = train.reference_steps(ref, cfg, mix, seed, device)
    out = {"workload": workload, "seed": seed}
    runs = {"program": rec,
            "control": train.reference_steps(ref, cfg, mix, seed, device,
                                             round_to=ref.fp8_rows),
            "half_batch": train.reference_steps(ref, cfg, mix, seed, device,
                                                rows=int(mix["batch"]) // 2)}
    for name, got in runs.items():
        got = dict(got, skipped=got.get("skipped", 0), steps=[])
        out[name] = train.numbers(got, r)
    out["losses"] = {"program": rec["losses"], "reference": r["losses"]}
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from bench.lib import spec as spec_lib
    spec = spec_lib.Spec(ROOT)
    kind = spec.traffic(spec.workload(args.workload)["traffic"])["kind"]
    sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    for seed in map(int, args.seeds.split(",")):
        if kind == "train":
            out = train_readings(ROOT, args.workload, seed, device, sync)
        else:
            out = readings(ROOT, args.workload, seed, args.seconds, device,
                           sync)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
