"""``bc_grad_w``'s device time at the training shapes, N = 8 x 1,024.

At k = 128: tinyllama-1.1b's q/o, k/v, up/gate, down and fused q/k/v and
up/gate (as ``chip_smoke.py:check_bc_grad_w``), qwen3-4b's up/gate and
down, phi-3-vision-4.2b's up/gate and down; and the expert stacks of the
MoE train phases (``chip_smoke.py:train_stack_shapes``: mixtral's 8
experts of 2,880 rows, llama4's 128 of 80; each stack one call, held
against the plain version expert by expert).  Each shape runs under the
kernel's own plan and, on a tree whose ``plan`` takes ``chunk``, under
other row chunks (``--chunks``; 0 is all N rows in one chunk), each
result held against ``bc_grad_w_plain`` (1e-4 of the output's scale) and
a second call bit-equal.  ``--profile`` adds the device time of each of
the call's CUDA kernels (``torch.profiler``).

    python3 tools/grad_w_sweep.py [--tree DIR] [--chunks 0,2048,1024]
                                  [--profile] [--shapes q_o,down]

``--tree`` imports ``repro_torch`` from ``DIR/src`` (a parent checkout
unpacked with ``git archive``: its own plan is timed, whatever it is).
Prints one JSON line per (shape, plan), then the card's ``nvidia-smi``
name and power limit.  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N, K = 8192, 128
# name -> (p, q): output and input blocks of k = 128
SHAPES = {"q_o": (16, 16), "k_v": (2, 16), "up_gate": (44, 16),
          "down": (16, 44), "fused_qkv": (20, 16), "fused_up_gate": (88, 16),
          "qwen3_up_gate": (76, 20), "qwen3_down": (20, 76),
          "phi3_up_gate": (64, 24), "phi3_down": (24, 64)}
# name -> (E, C, p, q): expert stacks of E experts of C rows
STACKS = {"mixtral_up_gate": (8, 2880, 112, 32),
          "mixtral_down": (8, 2880, 32, 112),
          "llama4_up_gate": (128, 80, 64, 40),
          "llama4_down": (128, 80, 40, 64)}


def event_ms(fn, reps: int = 5, inner: int = 4) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls,
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def profile_us(fn, calls: int = 4):
    """Device microseconds a call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
        if us and ("_kernel" in name or name.startswith("grad_w")):
            out[name] = us / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--chunks", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=f"of {', '.join([*SHAPES, *STACKS])}")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import bc_grad_w as bgw
    gen = torch.Generator(device="cuda").manual_seed(0)
    chunks = [int(c) for c in args.chunks.split(",") if c]
    for name in args.shapes.split(","):
        E, rows, p, q = STACKS[name] if name in STACKS else (1, N,
                                                             *SHAPES[name])
        lead = (E,) if name in STACKS else ()
        gy = torch.randn((*lead, rows, p, K), generator=gen, device="cuda")
        xb = torch.randn((*lead, rows, q, K), generator=gen, device="cuda")
        ref = (torch.stack([bgw.bc_grad_w_plain(gy[e], xb[e], K)
                            for e in range(E)]) if lead
               else bgw.bc_grad_w_plain(gy, xb, K))
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        variants = [("plan", lambda: bgw.bc_grad_w(gy, xb, K),
                     bgw.plan(rows, p, q, K))]
        if not lead and "chunk" in inspect.signature(bgw.plan).parameters:
            for c in chunks:
                pl = bgw.plan(N, p, q, K, c or N)
                variants.append((f"chunk{pl.chunk}",
                                 lambda c=pl.chunk: bgw.bc_grad_w(
                                     gy, xb, K, chunk=c), pl))
        for label, fn, pl in variants:
            got, again = fn(), fn()
            torch.cuda.synchronize()
            line = {"shape": name, "E": E, "N": rows, "p": p, "q": q, "k": K,
                    "tree": args.tree, "variant": label,
                    "plan": pl._asdict(),
                    "max_abs_err": float((got - ref).abs().max()),
                    "tol": tol, "bit_equal": bool(torch.equal(got, again)),
                    "device_ms": event_ms(fn)}
            if args.profile:
                line["kernels_us"] = profile_us(fn)
            print(json.dumps(line), flush=True)
        del gy, xb, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "no smi")
    return 0


if __name__ == "__main__":
    sys.exit(main())
