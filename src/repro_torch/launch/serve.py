"""Serving launcher for the port: the continuous-batching engine over the
paged KV pool, on the CUDA card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --device cpu --requests 4 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --device cpu --kv-dtype int8 --quant-weights --paged-attn gather

Weights are random, drawn from ``--seed`` (no checkpoint is loaded).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..device import resolve_device
from ..models.transformer import init_params
from ..quant.codec import QuantPolicy
from ..serve.engine import ContinuousEngine, Request
from ..serve.kvcache import servable_reasons


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per dispatch")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--paged-attn", default="stream",
                    choices=["stream", "gather"],
                    help="paged flash-decode kernel (default) or the "
                         "gather-then-attend oracle path")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="paged KV-pool storage dtype; int8 adds "
                         "per-(page, head) absmax scales")
    ap.add_argument("--quant-weights", action="store_true",
                    help="quantize the baked spectral weight planes to "
                         "fixed point (per-block-row absmax scales)")
    ap.add_argument("--weight-bits", type=int, default=8, choices=[8, 4],
                    help="with --quant-weights: int8 planes or packed int4 "
                         "(two nibbles per byte)")
    args = ap.parse_args(argv)

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    reasons = servable_reasons(cfg)
    if reasons:
        raise SystemExit(f"[launch.serve] {args.arch} is not continuous-"
                         f"servable ({'; '.join(reasons)})")
    device = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=device)
    engine = ContinuousEngine(cfg, params, max_slots=args.max_batch,
                              max_seq=64 + args.new_tokens,
                              page_size=args.page_size,
                              decode_chunk=args.decode_chunk,
                              eos_id=args.eos_id, device=device,
                              paged_attn=args.paged_attn,
                              quant=QuantPolicy(args.kv_dtype,
                                                args.quant_weights,
                                                args.weight_bits))
    rng = np.random.RandomState(args.seed)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=rng.randint(
        16, 32)).astype(np.int32), max_new_tokens=args.new_tokens, id=i)
        for i in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    dt = time.perf_counter() - t0
    st = engine.stats()
    toks = sum(r["decode_len"] for r in results)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[launch.serve] {args.arch} on {name}: {len(results)} requests, "
          f"{toks} tokens, {dt:.2f}s ({toks / dt:.1f} tok/s; prefill "
          f"{st['prefill_s']:.2f}s / decode {st['decode_s']:.2f}s)")
    nonzero = {s: n for s, n in st["statuses"].items() if n}
    print(f"[launch.serve] lifecycle: statuses={nonzero} "
          f"preempted={st['preempted']} anomalies={st['anomalies']} "
          f"prefills={st['prefills']} decode_steps={st['decode_steps']} "
          f"pool={st['pool_bytes'] / 1e6:.1f}MB "
          f"buckets={st['prefill_buckets']}")
    print(f"[launch.serve] quant={st['quant_policy']} "
          f"attention={st['attention_impl']} "
          f"attn_bytes/token={st['attention_bytes_per_token']} "
          f"decode_peak_est={st['decode_peak_bytes_est'] / 1e6:.1f}MB")


if __name__ == "__main__":
    main()
