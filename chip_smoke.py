#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

It imports neither ``jax`` nor ``repro``; it puts ``src/`` on ``sys.path``
itself.  Each phase prints one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi)
  build         nvcc time and library paths of the three CUDA kernels
  kernels       each kernel against its plain PyTorch version on the card, at
                the full-width tinyllama-1.1b shapes of the serving path:
                error and tolerance, kernel / plain / library times (median
                of CUDA-event timings), the roofline bound
  serve         full-width tinyllama-1.1b (random weights from a seed)
                through ``ContinuousEngine``: 16 requests, exact kernel
                launch counts per prefill and per decode step
  serve_parity  the same model in float32, one request on the card and on
                the CPU's plain path: prefill logits and greedy tokens agree

Then the card's name and power limit, the kernel summary
``{"kernels": [...]}``, and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code not 0, no last line); so does a machine
without a CUDA device.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.kernels import bc_fused, build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, Request  # noqa: E402
from repro_torch.serve.params import precompute_serving_params  # noqa: E402

ARCH = "tinyllama-1.1b"
SEED = 0
DEVICE = "cuda"
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory rate, float32 on the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
KERNELS = {
    "bc_fused": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48"),
    "flash_attention": (fa.KERNEL, "src/repro/kernels/flash_attention.py:75"),
    "paged_attention": (pa.KERNEL, "src/repro/kernels/paged_attention.py:181"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, divided by ``inner`` (L2 stays warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of the operands' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels: each CUDA kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------
def check_bc_fused(cfg, gen):
    a = cfg.attention
    d, dff, k = cfg.d_model, cfg.d_ff, cfg.compression.block_attn
    projections = {"q_o": (d, a.num_heads * a.head_dim),
                   "k_v": (d, a.num_kv_heads * a.head_dim),
                   "up_gate": (d, dff), "down": (dff, d)}
    kf = k // 2 + 1
    cases = []
    for name, (n_in, n_out) in projections.items():
        w = cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                    device="cuda")
        planes = cc.spectral_cache(w)
        wr, ws1, ws2 = planes["wr"], planes["ws1"], planes["ws2"]
        p, q, _ = wr.shape
        w_t = cc.materialize_dense(w, n_out, n_in).T.contiguous()
        for B in (8, 256):                   # decode slots, prefill rows
            xb = torch.randn((B, q, k), generator=gen, device="cuda")
            got = bc_fused.bc_fused_matmul(xb, wr, ws1, ws2, k)
            ref = bc_fused.bc_fused_matmul_plain(xb, wr, ws1, ws2, k)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            # float32 sums of a few hundred terms taken in another order:
            # expected ~1e-6 of the output's scale, held at 1e-4
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            x2 = xb.reshape(B, q * k)[:, :n_in]
            nbytes = 4 * (B * q * k + 3 * p * q * kf + 4 * k * kf + B * p * k)
            flops = (4 * B * q * k * kf + 6 * B * p * q * kf + B * q * kf
                     + 2 * B * p * kf + 4 * B * p * kf * k)
            bound_ms, bound_by = bound(nbytes, flops, torch.float32)
            cases.append({
                "case": f"{name}_b{B}", "shape": [B, p, q, k],
                "max_abs_err": err, "tol": tol,
                "kernel_ms": time_ms(lambda: bc_fused.bc_fused_matmul(
                    xb, wr, ws1, ws2, k)),
                "plain_ms": time_ms(lambda: bc_fused.bc_fused_matmul_plain(
                    xb, wr, ws1, ws2, k)),
                "library_ms": time_ms(lambda: x2 @ w_t),
                "library": "torch.matmul against the dense W",
                "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms, "bound_by": bound_by})
    return cases, "up_gate_b8"


def check_flash(cfg, gen):
    a = cfg.attention
    Hq, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    cases = []
    # (dtype, S): bf16 at the longest prompt the serve phase's max_seq of
    # 256 admits, f32 at the serve_parity prompt
    for dtype, S in ((torch.bfloat16, 256), (torch.float32, 48)):
        q = torch.randn((1, Hq, S, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, Hkv, S, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, Hkv, S, D), generator=gen, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        ref = fa.attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        if dtype == torch.bfloat16:
            # both sides compute in float32 and round once to bf16; the two
            # roundings may land one bf16 step (2^-8 relative) apart
            tol = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
        else:
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
        try:
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            kk, vv = k, v
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kk, vv, is_causal=True, enable_gqa=True)
        except TypeError:                    # torch without enable_gqa
            kk = k.repeat_interleave(Hq // Hkv, dim=1)
            vv = v.repeat_interleave(Hq // Hkv, dim=1)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kk, vv, is_causal=True)
        item = q.element_size()
        nbytes = item * (2 * q.numel() + k.numel() + v.numel())
        pairs = Hq * S * (S + 1) // 2          # causal (row, col) pairs
        flops = 4 * D * pairs
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        cases.append({
            "case": f"prefill_{str(dtype).split('.')[-1]}_s{S}",
            "shape": [1, Hq, Hkv, S, D], "max_abs_err": err, "tol": tol,
            "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v)),
            "library_ms": time_ms(lib),
            "library": "F.scaled_dot_product_attention(is_causal, enable_gqa)",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return cases, "prefill_bfloat16_s256"


def check_paged(cfg, gen):
    a = cfg.attention
    Hq, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    page, maxp, B = 16, 16, 8
    # mixed lengths: a partial last page (200, 17, 130, 95), page-aligned
    # ends (63, 239), a slot inside its first page (5), and an idle slot
    positions = torch.tensor([200, 17, 63, -1, 130, 5, 239, 95],
                             dtype=torch.int32, device="cuda")
    P = B * maxp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    table[3] = 0                              # idle slot owns no page
    pool_k = torch.randn((P, page, Hkv, D), generator=gen, device="cuda")
    pool_v = torch.randn((P, page, Hkv, D), generator=gen, device="cuda")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
        got = pa.paged_attention(q, pool_k, pool_v, table, positions)
        ref = pa.paged_attention_stream(q, pool_k, pool_v, table, positions)
        torch.cuda.synchronize()
        if not bool((got[3] == 0).all()):
            raise AssertionError("paged_attention: the idle slot is not "
                                 "exactly 0")
        err = max_err(got, ref)
        if dtype == torch.bfloat16:
            # float32 in both, one rounding to bf16 each (see check_flash)
            tol = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
        else:
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
        live = int((positions.clamp(min=-1) + 1).sum())
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * live * Hkv * D * pool_k.element_size()
                  + table.numel() * 4 + B * 4)
        flops = 4 * Hq * D * live
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        cases.append({
            "case": f"decode_{str(dtype).split('.')[-1]}_b{B}",
            "shape": [B, Hq, Hkv, D, page, maxp],
            "positions": positions.tolist(), "max_abs_err": err, "tol": tol,
            "idle_slot_exact_zero": True,
            "kernel_ms": time_ms(lambda: pa.paged_attention(
                q, pool_k, pool_v, table, positions)),
            "plain_ms": time_ms(lambda: pa.paged_attention_stream(
                q, pool_k, pool_v, table, positions)),
            "library_ms": None, "library": None,
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return cases, "decode_bfloat16_b8"


def phase_kernels(cfg):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {}
    for name, check in (("bc_fused", check_bc_fused),
                        ("flash_attention", check_flash),
                        ("paged_attention", check_paged)):
        cases, main_case = check(cfg, gen)
        out[name] = (cases, main_case)
        emit({"phase": "kernels", "kernel": name, "cases": cases})
        bad = [c["case"] for c in cases if not c["max_abs_err"] <= c["tol"]]
        if bad:
            raise AssertionError(f"{name}: over tolerance in {bad}")
    return out


# ---------------------------------------------------------------------------
# serve: the main path, full width, with exact launch counts
# ---------------------------------------------------------------------------
def make_requests(cfg, n, lo, hi, new_tokens, rng):
    lens = rng.randint(lo, hi + 1, size=n)
    lens[0], lens[-1] = lo, hi                # cover both ends
    return [Request(prompt=rng.randint(0, cfg.vocab_size, size=int(s))
                    .astype(np.int32), max_new_tokens=new_tokens, id=i)
            for i, s in enumerate(lens)]


def phase_serve(cfg):
    params = init_params(cfg, seed=SEED, device=DEVICE)
    kw = dict(max_slots=8, max_seq=256, page_size=16, decode_chunk=8,
              device=DEVICE)
    rng = np.random.RandomState(SEED)
    warm = ContinuousEngine(cfg, params, **kw)          # loads the libraries
    warm.generate(make_requests(cfg, 2, 17, 40, 4, rng))
    engine = ContinuousEngine(cfg, params, **kw)
    reqs = make_requests(cfg, 16, 17, 200, 32, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel, _ in KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernel.launches for name, (kernel, _) in KERNELS.items()}
    st = engine.stats()
    for r, req in zip(results, reqs):
        if (r["status"] != "FINISHED_BUDGET"
                or r["decode_len"] != req.max_new_tokens
                or len(r["tokens"]) != req.max_new_tokens
                or not all(0 <= t < cfg.vocab_size for t in r["tokens"])):
            raise AssertionError(f"request {req.id}: {r['status']}, "
                                 f"{r['decode_len']} tokens")
    if st["anomalies"]:
        raise AssertionError(f"{st['anomalies']} anomalies flagged")
    per_pass = 7 * cfg.num_layers              # q k v o up gate down
    want = {"bc_fused": per_pass * (st["prefills"] + st["decode_steps"]),
            "flash_attention": cfg.num_layers * st["prefills"],
            "paged_attention": cfg.num_layers * st["decode_steps"]}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    tokens = sum(r["decode_len"] for r in results)
    out = {"phase": "serve", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "requests": len(results),
           "prompt_lens": [len(r.prompt) for r in reqs],
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "prefills": st["prefills"], "decode_steps": st["decode_steps"],
           "decode_dispatches": st["dispatches"], "launches": launches,
           "launches_per_pass": {"bc_fused": per_pass,
                                 "flash_attention": cfg.num_layers,
                                 "paged_attention": cfg.num_layers},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "pool_bytes": st["pool_bytes"], "preempted": st["preempted"]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# serve_parity: float32, the card's kernels against the CPU's plain path
# ---------------------------------------------------------------------------
def phase_parity(cfg):
    cfg = cfg.replace(dtype="float32")
    rng = np.random.RandomState(SEED + 1)
    prompt = rng.randint(0, cfg.vocab_size, size=48).astype(np.int32)
    new = 16
    params = {"cpu": init_params(cfg, seed=SEED + 1, device="cpu")}
    params["card"] = copy.deepcopy(params["cpu"]).to(DEVICE)
    model = build_model(cfg)
    last = {}
    for key, p in params.items():
        dev = next(p.parameters()).device
        precompute_serving_params(p, cfg)
        cache = model.init_cache(1, len(prompt), dtype=torch.float32,
                                 device=dev)
        with torch.no_grad():
            logits, _ = model.prefill(p, {"tokens": torch.as_tensor(
                prompt[None], dtype=torch.int64, device=dev)}, cache)
        last[key] = logits[0, -1].float().cpu()
    scale = max(1.0, float(last["cpu"].abs().max()))
    # float32 through 22 layers with sums taken in another order on each
    # device: measured ~2e-6 of the logit scale on an H100, held at 1e-4
    logit_tol = 1e-4 * scale
    logit_err = max_err(last["card"], last["cpu"])
    if not logit_err <= logit_tol:
        raise AssertionError(f"prefill logits differ by {logit_err} > "
                             f"{logit_tol}")
    toks = {}
    for key, p in params.items():
        eng = ContinuousEngine(cfg, p, max_slots=2, max_seq=64, page_size=16,
                               decode_chunk=8,
                               device=next(p.parameters()).device)
        toks[key] = eng.generate([Request(prompt=prompt,
                                          max_new_tokens=new)])[0]["tokens"]
    # the CPU's top-1/top-2 margin at every greedy step, teacher-forced
    seq = np.concatenate([prompt, np.asarray(toks["cpu"][:-1], np.int32)])
    cache = model.init_cache(1, len(seq), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = model.prefill(params["cpu"], {"tokens": torch.as_tensor(
            seq[None], dtype=torch.int64)}, cache)
    top2 = torch.topk(logits[0, len(prompt) - 1:], 2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    # two logits each off by at most logit_tol can swap only if their gap
    # is under 2 * logit_tol; decode adds its own rounding, hence 4x
    near_tie = 4 * logit_tol
    agreed = 0
    for i, m in enumerate(margins):
        if m < near_tie:
            break
        if toks["card"][i] != toks["cpu"][i]:
            raise AssertionError(f"greedy token {i} differs: card "
                                 f"{toks['card'][i]}, cpu {toks['cpu'][i]} "
                                 f"(cpu margin {m})")
        agreed += 1
    out = {"phase": "serve_parity", "dtype": "float32", "prompt_len": 48,
           "new_tokens": new, "logit_max_abs_err": logit_err,
           "logit_tol": logit_tol, "near_tie": near_tie,
           "tokens_compared": agreed, "tokens_equal": toks["card"] == toks["cpu"],
           "min_margin": min(margins), "tokens_card": toks["card"],
           "tokens_cpu": toks["cpu"]}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvidia_smi": card, "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    secs = build.build()
    emit({"phase": "build", "nvcc_s": secs,
          "wall_s": time.perf_counter() - t0,
          "libraries": {n: str(build.library_path(n).relative_to(ROOT))
                        for n in build.KERNEL_NAMES},
          "ptxas": {n: [ln for ln in build.library_path(n).with_suffix(".log")
                        .read_text().splitlines() if "registers" in ln
                        or "spill" in ln]
                    for n in build.KERNEL_NAMES}})
    cfg = get_config(ARCH)
    kernels = phase_kernels(cfg)
    serve = phase_serve(cfg)
    phase_parity(cfg)
    summary = []
    for name, (kernel, replaces) in KERNELS.items():
        cases, main_case = kernels[name]
        c = next(c for c in cases if c["case"] == main_case)
        summary.append({
            "name": name, "route": "cuda",
            "source": str(kernel.source.relative_to(ROOT)),
            "replaces": replaces, "launches": serve["launches"][name],
            "case": main_case,
            "max_abs_err": c["max_abs_err"],
            "tol": c["tol"], "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_us": c["bound_ms"] * 1e3, "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
