"""Where a training step's device time goes, arch by arch, on the card.

For each arch: the published config (``--layers`` cuts it, as
``chip_smoke.py``'s train phases do for llama4), ``SyntheticLM`` batches of
``chip_smoke.py:TRAIN_ARCHS``' size, one warm-up ``TrainStep``, then one
step under ``torch.profiler``.  Prints one JSON line an arch: the step's
wall ms (host clock around the step, synchronised), the device ms summed
over its kernels and the idle share (1 - device / wall), the device ms by
group (the port's ``bc_fused`` and ``bc_grad_w``, dense matmuls, the
rest) and the largest kernels by device time; then the card's
``nvidia-smi`` name and power limit.

    python3 tools/train_profile.py [--archs mixtral-8x7b,gemma2-9b]

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# arch -> (batch, seq, layers or None), as chip_smoke.py:TRAIN_ARCHS
ARCHS = {"mixtral-8x7b": (2, 4608, None),
         "llama4-maverick-400b-a17b": (8, 1024, 8),
         "gemma2-9b": (2, 4608, None),
         "recurrentgemma-2b": (2, 2560, None),
         "xlstm-125m": (8, 1024, None),
         "whisper-large-v3": (8, 448, None)}
GROUPS = (("bc_fused", ("bc_fused",)), ("bc_grad_w", ("dft_kernel",
                                                      "mac_kernel",
                                                      "idft_kernel")),
          ("matmul", ("gemm", "sm90_", "cutlass", "ampere_", "cublas")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return "other"


def profile_step(arch: str, top: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    batch, seq, layers = ARCHS[arch]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    opt = adamw.AdamWConfig(lr=1e-3)
    state = ts.init_state(cfg, opt, seed=0, device="cuda")
    step = ts.make_train_step(cfg, opt)
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=0)
    state, _ = step(state, {k: v.cuda() for k, v in data(0).items()})
    torch.cuda.synchronize()
    b = {k: v.cuda() for k, v in data(1).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    groups = {}
    for name, us in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    device_ms = sum(kernels.values()) / 1e3
    largest = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    out = {"arch": arch, "batch": batch, "seq": seq,
           "layers": cfg.num_layers, "loss": float(metrics["loss"]),
           "wall_ms": 1e3 * wall, "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / (1e3 * wall),
           "device_ms_by_group": groups,
           "kernels": len(kernels),
           "largest_ms": [[name[:90], us / 1e3] for name, us in largest]}
    del state, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in args.archs.split(","):
        print(json.dumps(profile_step(arch, args.top)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "no smi")
    return 0


if __name__ == "__main__":
    sys.exit(main())
