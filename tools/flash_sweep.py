#!/usr/bin/env python3
"""Device time of the flash kernel over a sweep of prefill shapes, on one
CUDA card, to see what bounds the tensor-core lanes.

    python3 tools/flash_sweep.py [--out FILE]

For each shape (B, Hq, Hkv, S, D, causal) and dtype (float32: the 3xTF32
prefill; bf16) it prints one JSON line: the plan, the device time (a CUDA
graph of 10 calls replayed, median of 15), the attention FLOPs the shape
needs (4 D per visible (row, key) pair) and the rate they make.  The
shapes vary one thing at a time around phi-3-vision's oracle prefill
(S = 600, 32 / 32 heads of 96): no causal mask (1.8x the work, every block
as long as the longest causal one), 4x the batch (4x the blocks), a longer
sequence, the other head dims.  Exits 2 without a CUDA device.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = [  # (B, Hq, Hkv, S, D, causal)
    (1, 32, 32, 600, 96, True), (1, 32, 32, 600, 96, False),
    (4, 32, 32, 600, 96, True), (1, 32, 32, 2400, 96, True),
    (1, 32, 32, 600, 64, True), (1, 32, 32, 600, 128, True),
    (1, 32, 4, 600, 64, True), (1, 32, 32, 128, 96, True)]


def graph_ms(fn, inner=10, reps=15):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lines = []
    for B, Hq, Hkv, S, D, causal in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, S, D), generator=gen, device="cuda")
            k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
            v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
            q, k, v = (t.to(dtype) for t in (q, k, v))
            ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
            pairs = B * Hq * (S * (S + 1) // 2 if causal else S * S)
            flops = 4 * D * pairs
            pl = fa.plan(B, Hq, Hkv, S, S, D, dtype)
            line = {"shape": [B, Hq, Hkv, S, D], "causal": causal,
                    "dtype": str(dtype).split(".")[-1], "path": pl.path,
                    "blocks": pl.blocks, "device_ms": ms, "flops": flops,
                    "tflops": flops / ms / 1e9}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
