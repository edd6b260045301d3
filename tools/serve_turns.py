#!/usr/bin/env python3
"""Run chosen ``chip_smoke.py`` serve phases of two source trees in turns
on one CUDA card, so the two trees' times can be compared within one call.

    python3 tools/serve_turns.py --parent DIR [--change DIR] \\
        [--order PCCP] [--phases serve,serve_quant:8,serve_phi3] [--out FILE]

Each turn is a fresh process started in the tree's root: it imports that
tree's ``chip_smoke``, builds the tree's kernels (into the tree's own
``build/``; the first turn of a tree pays its ``nvcc`` time) and runs
``phase_<name>`` for each phase, which prints the phase's JSON line; a
phase that takes the tinyllama config gets it, and ``name:arg`` passes an
integer too (``serve_quant:4``: int4 planes).
Every line is kept with its turn and tree (``--out``, JSON lines), and a
table of the engines' prefill ms, ms per decode step, tokens per second
and ``bc_fused`` launches per forward pass is printed.  ``--change``
defaults to the tree this script is in.  Exits 2 without a CUDA device,
1 if a turn fails.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = """
import inspect
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
if not torch.cuda.is_available():
    sys.exit(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build.build()
cfg = cs.get_config(cs.ARCH)
for name in sys.argv[1:]:
    phase, _, arg = name.partition(":")
    fn = getattr(cs, "phase_" + phase)
    args = [cfg] if "cfg" in inspect.signature(fn).parameters else []
    fn(*args, *([int(arg)] if arg else []))
"""


def run_turn(tree: Path, phases):
    proc = subprocess.run([sys.executable, "-c", TURN, *phases], cwd=tree,
                          capture_output=True, text=True)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return proc.returncode, lines, proc.stderr[-2000:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--phases", default="serve_phi3,serve_moe")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    trees = {"P": args.parent.resolve(), "C": args.change.resolve()}
    phases = args.phases.split(",")
    kept, rows = [], []
    for turn, tag in enumerate(args.order):
        rc, lines, err = run_turn(trees[tag], phases)
        if rc == 2:
            print("serve_turns: no CUDA device", file=sys.stderr)
            return 2
        if rc != 0:
            print(f"turn {turn} ({tag}) failed, exit {rc}:\n{err}",
                  file=sys.stderr)
            return 1
        for line in lines:
            kept.append({"turn": turn, "tree": tag, **line})
            # serve_arch lines hold one run per engine; the serve phases'
            # lines are one continuous-engine run at their top level
            runs = {e: line[e] for e in ("batch", "continuous")
                    if isinstance(line.get(e), dict)}
            if not runs and "decode_steps" in line:
                runs = {"continuous": line}
            phase = line.get("phase")
            if "weight_bits" in line:
                phase = f"{phase}_int{line['weight_bits']}"
            per_pass = line.get("bc_fused_per_pass") or line.get(
                "launches_per_pass", {}).get("bc_fused")
            for engine, run in runs.items():
                rows.append((phase, engine, turn, tag,
                             1e3 * run["prefill_s"] / max(run["prefills"], 1),
                             1e3 * run["decode_s"]
                             / max(run["decode_steps"], 1),
                             run["tokens_per_s"], per_pass))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in kept))
    print("phase engine turn tree ms_per_prefill ms_per_step tokens_per_s "
          "bc_fused_per_pass")
    for r in sorted(rows, key=lambda r: (r[0], r[1], r[2])):
        print(*r[:4], *(f"{x:.2f}" for x in r[4:7]), r[7])
    return 0


if __name__ == "__main__":
    sys.exit(main())
