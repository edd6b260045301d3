#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

It imports neither ``jax`` nor ``repro``; it puts ``src/`` on ``sys.path``
itself.  Each phase prints one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi)
  build         nvcc time and library paths of the four CUDA libraries
  kernels       each kernel lane against its plain PyTorch version on the
                card, at the full-width tinyllama-1.1b shapes of the serving
                paths: error and tolerance, kernel / plain / library times
                (median of CUDA-event timings; the kernel also replayed
                from a CUDA graph, its device time), the roofline bound
  serve         full-width tinyllama-1.1b (random weights from a seed)
                through ``ContinuousEngine``: 16 requests, exact kernel
                launch counts per lane, per prefill and per decode step
  serve_parity  the same model in float32, one request on the card and on
                the CPU's plain path: prefill logits and greedy tokens agree
  serve_quant   the serve phase's requests under
                ``QuantPolicy("int8", quant_weights=True)``, once with int8
                and once with int4 planes: exact launch counts on the
                quantized lanes, none on the float lanes, the pool's bytes
  serve_gather  ``paged_attn="gather"`` on an f32 pool, 8 requests: 2 x 22
                ``paged_gather`` launches per decode step, no
                ``paged_attention``
  serve_quant_parity  float32, int8 pool and int8 planes, one request: the
                card against the CPU's plain path (prefill logits, then
                greedy tokens and step logits up to the first near-tie),
                and the card's gather path against its stream path
  serve_batch   the batch ``Engine`` with the serve phase's requests and
                settings: 2 bucketed prefills (the spectral MAC of every
                projection through ``spectral_matmul``), 62 decode steps
                against a float32 dense cache (``bc_fused`` and the flash
                kernel at one query row); exact launch counts
  serve_batch_quant  the same engine with int8 planes, 8 requests: no
                ``spectral_matmul`` launch (quantized caches skip the hook)
  serve_batch_parity  float32, one request: the card's B=1 ``Engine``
                against its ``ContinuousEngine`` and against the CPU's
                ``Engine``; per_token against scan; seeded sampling
  serve_qwen    qwen2.5-3b and qwen3-4b at their published widths and
                depth through both engines (exact launch counts), and the
                B=1 oracle check on one request each

The kernels phase adds ``spectral_matmul`` at every batch-prefill shape
(F = 65, N = 2048 rows), the whole projection at those shapes under three
lowerings (the hook, ``bc_fused``, dense ``torch.matmul``), the flash kernel
at the dense-decode shape, and ``bc_fused`` / ``paged_attention`` / the
flash kernel (head dim 128: bf16 prefill, float32 one-row decode) at qwen's
shapes.  Each case carries its launch plan where the kernel has one, and
``bound_share`` = bound / device time.

Then the card's name and power limit, the kernel summary
``{"kernels": [...]}`` (one entry per lane), and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code not 0, no last line); so does a machine
without a CUDA device.
"""
from __future__ import annotations

import copy
import ctypes
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
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged as pg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import spectral_matmul as sm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
from repro_torch.serve import decode as dec  # noqa: E402
from repro_torch.serve import kvcache as kvc  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      Request)
from repro_torch.serve.params import precompute_serving_params  # noqa: E402

ARCH = "tinyllama-1.1b"
SEED = 0
DEVICE = "cuda"
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory rate, float32 on the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
LIBRARIES = (bc_fused.KERNEL, fa.KERNEL, pa.KERNEL, pg.KERNEL, sm.KERNEL)
QWEN = ("qwen2.5-3b", "qwen3-4b")
ROWS = 8 * 256              # batch-prefill rows: 8 prompts padded to 256
# Every lane, one exported C function each: (library, the TPU kernel it
# replaces, the kernel-check group and case its times come from, the phase
# whose run gives its launch count).
LANES = {
    "bc_fused": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                 "bc_fused", "up_gate_b8", "serve"),
    "bc_fused_i8": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                    "bc_fused_i8", "up_gate_b8", "serve_quant_int8"),
    "bc_fused_i4": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                    "bc_fused_i4", "up_gate_b8", "serve_quant_int4"),
    "flash_attention": (fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
                        "flash_attention", "prefill_bfloat16_s256", "serve"),
    "paged_attention": (pa.KERNEL,
                        "src/repro/kernels/paged_attention.py:181",
                        "paged_attention", "decode_bfloat16_b8", "serve"),
    "paged_attention_i8": (pa.KERNEL,
                           "src/repro/kernels/paged_attention.py:181",
                           "paged_attention_i8", "decode_int8_float32_b8",
                           "serve_quant_int8"),
    "paged_gather": (pg.KERNEL, "src/repro/kernels/paged.py:37",
                     "paged_gather", "gather_float32_b8", "serve_gather"),
    "spectral_matmul": (sm.KERNEL,
                        "src/repro/kernels/spectral_matmul.py:42",
                        "spectral_matmul", "tinyllama_q_o_n2048",
                        "serve_batch"),
}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    script started, so each phase's share of the run can be read off."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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


def graph_ms(fn, inner: int = 10) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed and timed as ``time_ms`` times a call, so the host's work in
    the wrapper (checks, allocation, the ctypes call) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm: caches, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay) / inner


def kernel_times(fn):
    """``kernel_ms``: a wrapper call back to back (host enqueue included,
    the time a caller sees); ``device_ms``: the same call replayed from a
    CUDA graph (the kernel alone).  A capture that fails leaves
    ``device_ms`` None with the reason."""
    out = {"kernel_ms": time_ms(fn)}
    try:
        out["device_ms"] = graph_ms(fn)
    except RuntimeError as e:               # measurement only
        torch.cuda.synchronize()
        out["device_ms"], out["device_ms_error"] = None, str(e)[:300]
    return out


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
def projections(cfg):
    """name -> (n_in, n_out) of each distinct projection of an arch (q and
    o share a name where they share a shape)."""
    a = cfg.attention
    d, dff = cfg.d_model, cfg.d_ff
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    out = {"q_o": (d, hq)} if hq == d else {"q": (d, hq), "o": (hq, d)}
    out.update({"k_v": (d, hkv), "up_gate": (d, dff), "down": (dff, d)})
    return out


def new_projections(cfg):
    """The projections of ``cfg`` whose block shape (q, p) tinyllama-1.1b's
    do not already have, named ``<family>_<projection>``."""
    k = cfg.compression.block_attn
    blocks = lambda n_in, n_out: (cc.num_blocks(n_in, k),  # noqa: E731
                                  cc.num_blocks(n_out, k))
    seen = {blocks(*io) for io in projections(get_config(ARCH)).values()}
    family = cfg.name.split("-")[0]
    return {f"{family}_{name}": io for name, io in projections(cfg).items()
            if blocks(*io) not in seen}


def check_bc_fused(cfg, gen, shapes=None, batches=(8, 256),
                   lane_names=("bc_fused", "bc_fused_i8", "bc_fused_i4")):
    """The float32 lane and the int8 / int4 lanes, on the same weights and
    inputs at every projection, at B = 8 (decode slots) and 256 (prefill
    rows).  The quantized lanes get the same codes and scales as their plain
    version, so both sides contract identical values in float32."""
    k = cfg.compression.block_attn
    kf = k // 2 + 1
    lanes = {lane: [] for lane in lane_names}
    for name, (n_in, n_out) in (shapes or projections(cfg)).items():
        w = cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                    device="cuda")
        planes = cc.spectral_cache(w)
        variants = {"bc_fused": ((planes["wr"], planes["ws1"],
                                  planes["ws2"]), None, 4 * kf)}
        for bits, lane in ((8, "bc_fused_i8"), (4, "bc_fused_i4")):
            if lane not in lanes:
                continue
            qp = codec.quantize_plane_cache(planes, bits)
            variants[lane] = ((qp["wr"], qp["ws1"], qp["ws2"]),
                              [qp[n + "_s"] for n in ("wr", "ws1", "ws2")],
                              qp["wr"].shape[-1] * qp["wr"].element_size())
        p, q, _ = planes["wr"].shape
        w_t = cc.materialize_dense(w, n_out, n_in).T.contiguous()
        for B in batches:                    # decode slots, prefill rows
            xb = torch.randn((B, q, k), generator=gen, device="cuda")
            x2 = xb.reshape(B, q * k)[:, :n_in]
            library_ms = time_ms(lambda: x2 @ w_t)
            for lane, (pl, scales, row_bytes) in variants.items():
                got = bc_fused.bc_fused_matmul(xb, *pl, k, scales)
                ref = bc_fused.bc_fused_matmul_plain(xb, *pl, k, scales)
                torch.cuda.synchronize()
                err = max_err(got, ref)
                # float32 sums of a few hundred terms taken in another
                # order, over identical plane values: expected ~1e-6 of the
                # output's scale, held at 1e-4
                tol = 1e-4 * max(1.0, float(ref.abs().max()))
                nbytes = (4 * (B * q * k + 4 * k * kf + B * p * k)
                          + 3 * p * q * row_bytes
                          + (0 if scales is None else 3 * 4 * p))
                flops = (4 * B * q * k * kf + 6 * B * p * q * kf
                         + B * q * kf + 2 * B * p * kf + 4 * B * p * kf * k
                         + (0 if scales is None else 3 * B * p * kf))
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                lanes[lane].append({
                    "case": f"{name}_b{B}", "shape": [B, p, q, k],
                    "plan": bc_fused.plan(B, p, q, k, lane)._asdict(),
                    "planes": str(pl[0].dtype).split(".")[-1],
                    "max_abs_err": err, "tol": tol,
                    **kernel_times(lambda: bc_fused.bc_fused_matmul(
                        xb, *pl, k, scales)),
                    "plain_ms": time_ms(
                        lambda: bc_fused.bc_fused_matmul_plain(
                            xb, *pl, k, scales)),
                    "library_ms": library_ms,
                    "library": "torch.matmul against the dense W (float32)",
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return {lane: (cases, "up_gate_b8") for lane, cases in lanes.items()}


def check_flash(cfg, gen, prefix=""):
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
            "case": f"{prefix}prefill_{str(dtype).split('.')[-1]}_s{S}",
            "shape": [1, Hq, Hkv, S, D], "max_abs_err": err, "tol": tol,
            **kernel_times(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v)),
            "library_ms": time_ms(lib),
            "library": "F.scaled_dot_product_attention(is_causal, enable_gqa)",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"flash_attention": (cases, "prefill_bfloat16_s256")}


def check_paged(cfg, gen, float_only=False, prefix=""):
    """The float lanes (bf16 and f32 queries on an f32 pool) and the int8
    lane (the same pool quantized per (page, head); f32 and bf16 queries),
    at the serve phase's 8 slots and mixed positions.  ``float_only``: the
    bf16-query, f32-pool case alone (``prefix`` names its arch)."""
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
    k8, ks = codec.quantize_page_block(pool_k)
    v8, vs = codec.quantize_page_block(pool_v)
    live = int((positions.clamp(min=-1) + 1).sum())
    live_pages = int(((positions + page) // page).clamp(min=0).sum())
    lanes = {"paged_attention": [], "paged_attention_i8": []}
    variants = (("paged_attention", torch.bfloat16, pool_k, pool_v, {}),
                ("paged_attention", torch.float32, pool_k, pool_v, {}),
                ("paged_attention_i8", torch.float32, k8, v8,
                 {"k_scale": ks, "v_scale": vs}),
                ("paged_attention_i8", torch.bfloat16, k8, v8,
                 {"k_scale": ks, "v_scale": vs}))
    for lane, dtype, pk, pv, scales in variants[:1 if float_only else 4]:
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
        got = pa.paged_attention(q, pk, pv, table, positions, **scales)
        ref = pa.paged_attention_stream(q, pk, pv, table, positions,
                                        **scales)
        torch.cuda.synchronize()
        if not bool((got[3] == 0).all()):
            raise AssertionError(f"{lane}: the idle slot is not exactly 0")
        err = max_err(got, ref)
        if dtype == torch.bfloat16:
            # float32 in both, one rounding to bf16 each (see check_flash)
            tol = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
        else:
            # identical codes and scales on both sides: float32 sums in
            # another order, held at 1e-4 of the output's scale
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * live * Hkv * D * pk.element_size()
                  + (2 * live_pages * Hkv * 4 if scales else 0)
                  + table.numel() * 4 + B * 4)
        flops = 4 * Hq * D * live + (2 * live * Hkv * D if scales else 0)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        pool_name = "int8" if scales else "float32"
        lanes[lane].append({
            "case": prefix + (
                f"decode_int8_{str(dtype).split('.')[-1]}_b{B}"
                if scales else f"decode_{str(dtype).split('.')[-1]}_b{B}"),
            "shape": [B, Hq, Hkv, D, page, maxp], "pool": pool_name,
            "positions": positions.tolist(), "max_abs_err": err, "tol": tol,
            "idle_slot_exact_zero": True,
            **kernel_times(lambda: pa.paged_attention(
                q, pk, pv, table, positions, **scales)),
            "plain_ms": time_ms(lambda: pa.paged_attention_stream(
                q, pk, pv, table, positions, **scales)),
            "library_ms": None, "library": None,
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"paged_attention": (lanes["paged_attention"],
                                "decode_bfloat16_b8"),
            "paged_attention_i8": (lanes["paged_attention_i8"],
                                   "decode_int8_float32_b8")}


def check_gather(cfg, gen):
    """The gather at the serve_gather phase's pool (8 slots x 16 pages of
    16): f32, bf16 and int8 pools, held exactly against ``pool[table]``."""
    a = cfg.attention
    Hkv, D = a.num_kv_heads, a.head_dim
    page, maxp, B = 16, 16, 8
    P = B * maxp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    table[3, 4:] = 0                          # a slot with a short history
    table_long = table.long()
    base = (torch.randn((P, page, Hkv, D), generator=gen, device="cuda")
            * 40).clamp(-127, 127)
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        pool = base.to(dtype)
        got = pg.paged_gather(pool, table)
        ref = pg.paged_gather_plain(pool, table)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        nbytes = 2 * B * maxp * page * Hkv * D * pool.element_size() \
            + table.numel() * 4
        bound_ms, bound_by = bound(nbytes, 0, torch.float32)
        cases.append({
            "case": f"gather_{str(dtype).split('.')[-1]}_b{B}",
            "shape": [P, page, Hkv, D, B, maxp], "max_abs_err": err,
            "tol": 0.0,                       # a copy: exact
            **kernel_times(lambda: pg.paged_gather(pool, table)),
            "plain_ms": time_ms(lambda: pg.paged_gather_plain(pool, table)),
            "library_ms": time_ms(lambda: pool[table_long]),
            "library": "pool[table] (advanced indexing)",
            "bytes": nbytes, "flops": 0,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"paged_gather": (cases, "gather_float32_b8")}


def check_flash_decode(cfg, gen, prefix=""):
    """The batch engine's decode attention: 8 rows of one query each over a
    float32 dense cache of 231 positions (kv_offset 230), the longest the
    serve_batch phase reaches (prompt 200 + 31 decode steps); the G query
    heads of a KV head share a block and the keys split over blocks."""
    a = cfg.attention
    Hq, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    B, Skv = 8, 231
    q = torch.randn((B, Hq, 1, D), generator=gen, device="cuda")
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda")
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda")
    off = Skv - 1
    got = fa.flash_attention(q, k, v, causal=True, kv_offset=off)
    ref = fa.attention_ref(q, k, v, causal=True, kv_offset=off)
    torch.cuda.synchronize()
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, enable_gqa=True)
    except TypeError:                        # torch without enable_gqa
        kk = k.repeat_interleave(Hq // Hkv, dim=1)
        vv = v.repeat_interleave(Hq // Hkv, dim=1)
        lib = lambda: F.scaled_dot_product_attention(q, kk, vv)  # noqa: E731
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * D * B * Hq * Skv
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    case = {
        "case": f"{prefix}decode_float32_b{B}_skv{Skv}",
        "shape": [B, Hq, Hkv, 1, Skv, D], "kv_offset": off,
        "plan": {**fa.plan(B, Hq, Hkv, 1, Skv, D, torch.float32)._asdict(),
                 "dtype": "float32"},
        "max_abs_err": max_err(got, ref),
        "tol": 1e-4 * max(1.0, float(ref.abs().max())),
        **kernel_times(lambda: fa.flash_attention(q, k, v, causal=True,
                                                  kv_offset=off)),
        "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v, causal=True,
                                                     kv_offset=off)),
        "library_ms": time_ms(lib),
        "library": "F.scaled_dot_product_attention(enable_gqa), one row",
        "bytes": nbytes, "flops": flops,
        "bound_ms": bound_ms, "bound_by": bound_by}
    return {"flash_attention": ([case], None)}


def spectral_shapes():
    """(name, n_in, n_out, k) of every distinct batch-prefill projection
    of tinyllama-1.1b and the qwen models."""
    tiny = get_config(ARCH)
    k = tiny.compression.block_attn
    out = [(f"tinyllama_{n}", *io, k) for n, io in projections(tiny).items()]
    for arch in QWEN:
        cfg = get_config(arch)
        out += [(n, *io, cfg.compression.block_attn)
                for n, io in new_projections(cfg).items()]
    return out


def check_spectral(cfg, gen):
    """``spectral_matmul`` against its plain version at every batch-prefill
    shape (F = 65, N = 2048 rows), with the library time of one complex64
    ``torch.matmul`` computing the same product."""
    cases = []
    for name, n_in, n_out, k in spectral_shapes():
        F_, N = k // 2 + 1, ROWS
        Q, P = cc.num_blocks(n_in, k), cc.num_blocks(n_out, k)
        xr, xi = (torch.randn((F_, N, Q), generator=gen, device="cuda")
                  for _ in range(2))
        wr, ws1, ws2 = (torch.randn((F_, Q, P), generator=gen,
                                    device="cuda") * Q ** -0.5
                        for _ in range(3))
        planes = (xr, xi, wr, ws1, ws2)
        got = sm.spectral_matmul(*planes)
        ref = sm.spectral_matmul_plain(*planes)
        torch.cuda.synchronize()
        err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        # float32 sums of Q terms in another order: ~1e-6 of the scale
        tol = 1e-4 * max(1.0, float(ref[0].abs().max()),
                         float(ref[1].abs().max()))
        xc, wc = torch.complex(xr, xi), torch.complex(wr, ws1 + wr)
        nbytes = 4 * F_ * (2 * N * Q + 3 * Q * P + 2 * N * P)
        flops = 6 * F_ * N * Q * P
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        cases.append({
            "case": f"{name}_n{N}", "shape": [F_, N, Q, P],
            "max_abs_err": err, "tol": tol,
            **kernel_times(lambda: sm.spectral_matmul(*planes)),
            "plain_ms": time_ms(lambda: sm.spectral_matmul_plain(*planes)),
            "library_ms": time_ms(lambda: torch.matmul(xc, wc)),
            "library": "torch.matmul on complex64 (F, N, Q) @ (F, Q, P)",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"spectral_matmul": (cases, "tinyllama_q_o_n2048")}


def phase_lowering(cfg, gen):
    """One projection at N = 2048 rows (tinyllama-1.1b's batch prefill),
    device times (CUDA-graph replay) of three lowerings: the hook path
    (DFT product, permutes, ``spectral_matmul``, permutes, iDFT product),
    ``bc_fused``, and dense ``torch.matmul`` against the materialized W.
    The hook path's parts are timed one by one as well."""
    k = cfg.compression.block_attn
    rows = []
    for name, (n_in, n_out) in projections(cfg).items():
        w = cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                    device="cuda")
        cache = cc.spectral_cache(w)
        x = torch.randn((ROWS, n_in), generator=gen, device="cuda")
        w_t = cc.materialize_dense(w, n_out, n_in).T.contiguous()
        hook = lambda: cc.bc_matmul_spectral(  # noqa: E731
            x, cache, k, n_out, True, kops.spectral_contract)
        fused = lambda: kops.bc_linear(x, cache, k, n_out)  # noqa: E731
        dense = lambda: x @ w_t  # noqa: E731
        want = dense()
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        errs = {"hook": max_err(hook(), want), "bc_fused": max_err(
            fused(), want)}
        if not max(errs.values()) <= tol:
            raise AssertionError(f"lowering {name}: {errs} > {tol}")
        p, q, kf = cache["wr"].shape
        xb = cc._blockify(x, q, k).float()
        xr, xi = cc.rfft_planes(xb, k)
        to_x = lambda t: t.reshape(-1, q, kf).permute(  # noqa: E731
            2, 0, 1).contiguous()
        to_w = lambda t: t.permute(2, 1, 0).contiguous()  # noqa: E731
        args = (to_x(xr), to_x(xi), *(to_w(cache[n])
                                      for n in ("wr", "ws1", "ws2")))
        yr, yi = sm.spectral_matmul(*args)
        ybr, ybi = (t.permute(1, 2, 0).reshape(ROWS, p, kf)
                    for t in (yr, yi))
        parts = {
            "dft": lambda: cc.rfft_planes(xb, k),
            "permute_in": lambda: (to_x(xr), to_x(xi), *(
                to_w(cache[n]) for n in ("wr", "ws1", "ws2"))),
            "spectral_matmul": lambda: sm.spectral_matmul(*args),
            "idft": lambda: cc.irfft_planes(ybr, ybi, k)}
        rows.append({
            "projection": name, "rows": ROWS, "shape": [p, q, k],
            "max_abs_err_vs_dense": errs, "tol": tol,
            "device_ms": {"hook": graph_ms(hook), "bc_fused": graph_ms(fused),
                          "dense_matmul": graph_ms(dense)},
            "hook_parts_device_ms": {n: graph_ms(f)
                                     for n, f in parts.items()}})
    emit({"phase": "lowering", "projections": rows})
    return rows


def kernel_gen():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return gen


def phase_kernels(cfg):
    gen = kernel_gen()
    qwen = {arch: get_config(arch) for arch in QWEN}
    checks = [lambda: check_bc_fused(cfg, gen),
              lambda: check_flash(cfg, gen),
              lambda: check_flash_decode(cfg, gen),
              lambda: check_paged(cfg, gen),
              lambda: check_gather(cfg, gen),
              lambda: check_spectral(cfg, gen)]
    for qc in qwen.values():                 # the shapes qwen adds
        family = qc.name.split("-")[0]
        checks += [
            lambda qc=qc: check_bc_fused(qc, gen, new_projections(qc),
                                         lane_names=("bc_fused",)),
            lambda qc=qc, f=family: check_paged(qc, gen, float_only=True,
                                                prefix=f"{f}_"),
            # head dim 128: the other tensor-core tiling of the bf16 lane
            lambda qc=qc, f=family: check_flash(qc, gen, prefix=f"{f}_"),
            lambda qc=qc, f=family: check_flash_decode(qc, gen,
                                                       prefix=f"{f}_")]
    out = {}
    for check in checks:
        for lane, (cases, main_case) in check().items():
            if not cases:
                continue
            for c in cases:                  # share of the bound reached
                c["bound_share"] = (c["bound_ms"] / c["device_ms"]
                                    if c.get("device_ms") else None)
            out.setdefault(lane, ([], main_case))[0].extend(cases)
            emit({"phase": "kernels", "kernel": lane, "cases": cases})
            bad = [c["case"] for c in cases
                   if not c["max_abs_err"] <= c["tol"]]
            if bad:
                raise AssertionError(f"{lane}: over tolerance in {bad}")
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


def lane_counts():
    return {fn: n for lib in LIBRARIES for fn, n in lib.fn_launches.items()}


def timed_run(engine, reqs):
    """``engine.generate(reqs)`` with every launch count set to 0 just
    before; (results, stats, launches per lane, wall s, peak device
    memory).  Every request must finish on its budget."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for lib in LIBRARIES:
        lib.reset_counts()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lane_counts()
    for r, req in zip(results, reqs):
        if (r["status"] != "FINISHED_BUDGET"
                or r["decode_len"] != req.max_new_tokens
                or len(r["tokens"]) != req.max_new_tokens
                or not all(0 <= t < engine.cfg.vocab_size
                           for t in r["tokens"])):
            raise AssertionError(f"request {req.id}: {r['status']}, "
                                 f"{r['decode_len']} tokens")
    return (results, engine.stats(), launches, wall,
            torch.cuda.max_memory_allocated())


def serve_run(cfg, n_requests, **engine_kw):
    """Fresh random weights from the seed, a warm-up engine (loads the
    libraries), then ``n_requests`` of the serve phase's requests through a
    second engine (``timed_run``).  Returns (results, requests, stats,
    launches per lane, wall seconds, peak device memory)."""
    params = init_params(cfg, seed=SEED, device=DEVICE)
    kw = dict(max_slots=8, max_seq=256, page_size=16, decode_chunk=8,
              device=DEVICE, **engine_kw)
    rng = np.random.RandomState(SEED)
    warm = ContinuousEngine(cfg, params, **kw)
    warm.generate(make_requests(cfg, 2, 17, 40, 4, rng))
    reqs = make_requests(cfg, 16, 17, 200, 32, rng)[:n_requests]
    results, st, launches, wall, peak = timed_run(
        ContinuousEngine(cfg, params, **kw), reqs)
    if st["anomalies"]:
        raise AssertionError(f"{st['anomalies']} anomalies flagged")
    return results, reqs, st, launches, wall, peak


def check_launches(launches, want):
    """Every lane's count is exactly what the run's prefills and decode
    steps call for (0 for the lanes the run must not touch)."""
    want = {fn: want.get(fn, 0) for fn in launches}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")


def serve_summary(phase, cfg, results, reqs, st, launches, wall, peak):
    tokens = sum(r["decode_len"] for r in results)
    return {"phase": phase, "arch": ARCH, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "requests": len(results),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "decode_dispatches": st["dispatches"], "launches": launches,
            "peak_memory_bytes": peak, "pool_bytes": st["pool_bytes"],
            "preempted": st["preempted"], "quant_policy": st["quant_policy"],
            "attention_impl": st["attention_impl"],
            "attention_bytes_per_token": st["attention_bytes_per_token"],
            "decode_peak_bytes_est": st["decode_peak_bytes_est"]}


def phase_serve(cfg):
    results, reqs, st, launches, wall, peak = serve_run(cfg, 16)
    per_pass = 7 * cfg.num_layers              # q k v o up gate down
    check_launches(launches, {
        "bc_fused": per_pass * (st["prefills"] + st["decode_steps"]),
        "flash_attention": cfg.num_layers * st["prefills"],
        "paged_attention": cfg.num_layers * st["decode_steps"]})
    out = serve_summary("serve", cfg, results, reqs, st, launches, wall, peak)
    out["launches_per_pass"] = {"bc_fused": per_pass,
                                "flash_attention": cfg.num_layers,
                                "paged_attention": cfg.num_layers}
    emit(out)
    return out


def phase_serve_quant(cfg, bits):
    """The serve phase's 16 requests and engine settings, with an int8
    pool and int8 / int4 planes: every projection on the quantized lane,
    every decode attention on the int8 lane."""
    policy = codec.QuantPolicy("int8", quant_weights=True, weight_bits=bits)
    results, reqs, st, launches, wall, peak = serve_run(cfg, 16,
                                                        quant=policy)
    per_pass = 7 * cfg.num_layers
    lane = "bc_fused_i8" if bits == 8 else "bc_fused_i4"
    check_launches(launches, {
        lane: per_pass * (st["prefills"] + st["decode_steps"]),
        "flash_attention": cfg.num_layers * st["prefills"],
        "paged_attention_i8": cfg.num_layers * st["decode_steps"]})
    a = cfg.attention
    pages = 8 * kvc.pages_for(256, 16) + 1
    want_bytes = (2 * cfg.num_layers * pages * 16 * a.num_kv_heads
                  * a.head_dim + 2 * 4 * cfg.num_layers * pages
                  * a.num_kv_heads)
    if st["pool_bytes"] != want_bytes:
        raise AssertionError(f"int8 pool holds {st['pool_bytes']} bytes, "
                             f"expected {want_bytes}")
    out = serve_summary(f"serve_quant_int{bits}", cfg, results, reqs, st,
                        launches, wall, peak)
    out["phase"] = "serve_quant"
    out["weight_bits"] = bits
    out["kv_clip_rate"] = st["kv_clip_rate"]
    emit(out)
    return out


def phase_serve_gather(cfg):
    """The gather oracle on an f32 pool: each decode step gathers K and V
    of every layer and attends with a masked softmax in PyTorch."""
    results, reqs, st, launches, wall, peak = serve_run(cfg, 8,
                                                        paged_attn="gather")
    per_pass = 7 * cfg.num_layers
    check_launches(launches, {
        "bc_fused": per_pass * (st["prefills"] + st["decode_steps"]),
        "flash_attention": cfg.num_layers * st["prefills"],
        "paged_gather": 2 * cfg.num_layers * st["decode_steps"]})
    out = serve_summary("serve_gather", cfg, results, reqs, st, launches,
                        wall, peak)
    out["launches_per_decode_step"] = {"paged_gather": 2 * cfg.num_layers,
                                       "paged_attention": 0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# serve_batch: the batch Engine on the serve phase's requests
# ---------------------------------------------------------------------------
def batch_run(cfg, n_requests, **engine_kw):
    """The serve phase's warm-up and requests (same seed, same draws)
    through the batch ``Engine`` on fresh random weights."""
    params = init_params(cfg, seed=SEED, device=DEVICE)
    kw = dict(max_batch=8, max_seq=256, device=DEVICE, **engine_kw)
    rng = np.random.RandomState(SEED)
    Engine(cfg, params, **kw).generate(make_requests(cfg, 2, 17, 40, 4, rng))
    reqs = make_requests(cfg, 16, 17, 200, 32, rng)[:n_requests]
    return (reqs, *timed_run(Engine(cfg, params, **kw), reqs))


def batch_summary(phase, cfg, results, reqs, st, launches, wall, peak):
    tokens = sum(r["decode_len"] for r in results)
    return {"phase": phase, "arch": cfg.name, "engine": "batch",
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "requests": len(results),
            "prompt_lens": [len(r.prompt) for r in reqs], "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "ms_per_step": 1e3 * st["decode_s"] / max(st["decode_steps"], 1),
            "padded_prompt_tokens": st["padded_prompt_tokens"],
            "launches": launches, "peak_memory_bytes": peak,
            "cache_bytes": st["cache_bytes"],
            "quant_policy": st["quant_policy"]}


def batch_launches(cfg, st, lane="bc_fused", hooked=True):
    """What one batch-engine run must launch: every projection of a
    prefill through ``spectral_matmul`` (float32 planes, ``hooked``) or the
    fused kernel's lane, every decode projection through the fused kernel,
    the flash kernel once per layer and forward pass."""
    per_pass = 7 * cfg.num_layers
    pre, steps = st["prefills"], st["decode_steps"]
    want = {lane: per_pass * (steps + (0 if hooked else pre)),
            "flash_attention": cfg.num_layers * (pre + steps)}
    if hooked:
        want["spectral_matmul"] = per_pass * pre
    return want


def phase_serve_batch(cfg):
    reqs, results, st, launches, wall, peak = batch_run(cfg, 16)
    if (st["prefills"], st["decode_steps"]) != (2, 62):
        raise AssertionError(f"{st['prefills']} prefills and "
                             f"{st['decode_steps']} decode steps, expected "
                             f"2 and 62")
    want = batch_launches(cfg, st)
    check_launches(launches, want)
    plan = (want["spectral_matmul"], want["bc_fused"],
            want["flash_attention"])
    if plan != (308, 9548, 1408):
        raise AssertionError(f"serve_batch launch plan {plan}, expected "
                             f"(308, 9548, 1408)")
    out = batch_summary("serve_batch", cfg, results, reqs, st, launches,
                        wall, peak)
    emit(out)
    return out


def phase_serve_batch_quant(cfg):
    """int8 planes: the hook's skip rule on the card, every projection on
    the fused kernel's int8 lane at prefill and at decode."""
    reqs, results, st, launches, wall, peak = batch_run(
        cfg, 8, quant=codec.QuantPolicy(quant_weights=True))
    check_launches(launches, batch_launches(cfg, st, "bc_fused_i8",
                                            hooked=False))
    out = batch_summary("serve_batch_quant", cfg, results, reqs, st,
                        launches, wall, peak)
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


# ---------------------------------------------------------------------------
# serve_quant_parity: float32, int8 pool and int8 planes, card against CPU
# ---------------------------------------------------------------------------
def greedy_trace(cfg, params, prompt, new, policy, paged_impl):
    """One request through the serving path by hand (right-padded B=1
    prefill, int8 page packing with ``true_len``, paged decode steps):
    (greedy tokens, the logits of every step as a (new, V) CPU tensor)."""
    dev = next(params.parameters()).device
    model = build_model(cfg)
    page, S = 16, len(prompt)
    n_pages = kvc.pages_for(S + new, page)
    pool = kvc.build_pool(cfg, n_pages + 1, page, policy, device=dev)
    pages = torch.arange(1, n_pages + 1, device=dev)
    pp = kvc.pages_for(S, page)
    toks = np.zeros(pp * page, np.int64)
    toks[:S] = prompt
    with torch.no_grad():
        cache = model.init_cache(1, pp * page, dtype=torch.float32,
                                 device=dev)
        logits, dense = model.prefill(params, {"tokens": torch.as_tensor(
            toks[None], device=dev)}, cache)
        kvc.pack_prefill_cache(pool, dense, pages[:pp], page, true_len=S)
        steps = [logits[0, S - 1].float().cpu()]
        table = pages[None].to(torch.int32)
        for i in range(new - 1):
            cur = torch.tensor([[int(steps[-1].argmax())]], device=dev)
            pos = torch.tensor([S + i], dtype=torch.int32, device=dev)
            logits, pool = model.decode_step(params, cur, pool, pos,
                                             block_table=table,
                                             paged_impl=paged_impl)
            steps.append(logits[0, -1].float().cpu())
    lg = torch.stack(steps)
    return lg.argmax(-1).tolist(), lg


def compare_traces(a, b, tol):
    """Greedy tokens of two traces, step by step, with the step logits
    held to ``tol``.  While the tokens agree both traces have read the
    same inputs; where they first differ, the gap between the top two
    logits of trace ``b`` must be within twice that step's measured logit
    error (a near-tie), and the comparison stops there."""
    (ta, la), (tb, lb) = a, b
    errs = []
    for i in range(len(ta)):
        err = max_err(la[i], lb[i])
        errs.append(err)
        if not err <= tol:
            raise AssertionError(f"step {i}: logits differ by {err} > {tol}")
        if ta[i] != tb[i]:
            top2 = torch.topk(lb[i], 2).values
            margin = float(top2[0] - top2[1])
            if margin > 2 * err:
                raise AssertionError(f"step {i}: greedy tokens {ta[i]} vs "
                                     f"{tb[i]} with a margin of {margin} "
                                     f"> 2 x {err}")
            return {"tokens_compared": i, "diverged_at": i,
                    "margin_at_divergence": margin, "max_step_err": max(errs)}
    return {"tokens_compared": len(ta), "diverged_at": None,
            "max_step_err": max(errs)}


def phase_quant_parity(cfg):
    cfg = cfg.replace(dtype="float32")
    policy = codec.QuantPolicy("int8", quant_weights=True)
    rng = np.random.RandomState(SEED + 2)
    prompt = rng.randint(0, cfg.vocab_size, size=48).astype(np.int32)
    new = 16
    # planes baked and quantized once, on the CPU: both devices serve the
    # same int8 codes and scales
    cpu = precompute_serving_params(
        init_params(cfg, seed=SEED + 2, device="cpu"), cfg, policy)
    card = copy.deepcopy(cpu).to(DEVICE)
    model = build_model(cfg)
    last = {}
    for key, p in (("cpu", cpu), ("card", card)):
        dev = next(p.parameters()).device
        cache = model.init_cache(1, len(prompt), dtype=torch.float32,
                                 device=dev)
        with torch.no_grad():
            logits, _ = model.prefill(p, {"tokens": torch.as_tensor(
                prompt[None], dtype=torch.int64, device=dev)}, cache)
        last[key] = logits[0, -1].float().cpu()
    scale = max(1.0, float(last["cpu"].abs().max()))
    # the prefill reads no pool: identical int8 planes, float32 sums in
    # another order, as serve_parity (measured ~1e-5 of the scale there)
    logit_tol = 1e-4 * scale
    logit_err = max_err(last["card"], last["cpu"])
    if not logit_err <= logit_tol:
        raise AssertionError(f"prefill logits differ by {logit_err} > "
                             f"{logit_tol}")
    # decode reads the int8 pool, quantized on each device from K/V that
    # differ by float32 rounding: a value on a rounding boundary may take
    # the neighbouring code, so step logits are held at 1e-2 of the scale
    step_tol = 1e-2 * scale
    traces = {"cpu": greedy_trace(cfg, cpu, prompt, new, policy, "stream"),
              "card": greedy_trace(cfg, card, prompt, new, policy, "stream"),
              "card_gather": greedy_trace(cfg, card, prompt, new, policy,
                                          "gather")}
    card_vs_cpu = compare_traces(traces["card"], traces["cpu"], step_tol)
    gather_vs_stream = compare_traces(traces["card_gather"], traces["card"],
                                      step_tol)
    out = {"phase": "serve_quant_parity", "dtype": "float32",
           "quant_policy": policy.describe(), "prompt_len": len(prompt),
           "new_tokens": new, "prefill_logit_max_abs_err": logit_err,
           "prefill_logit_tol": logit_tol, "step_logit_tol": step_tol,
           "card_vs_cpu": card_vs_cpu, "gather_vs_stream": gather_vs_stream,
           "tokens": {k: t for k, (t, _) in traces.items()}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# serve_batch_parity / serve_qwen: the B=1 oracle on the card
# ---------------------------------------------------------------------------
def batch_trace(cfg, params, prompt, new):
    """One request through the batch engine's path by hand (the hooked
    prefill, then greedy decode steps against the float32 dense cache):
    (greedy tokens, the logits of every step as a (new, V) CPU tensor)."""
    dev = next(params.parameters()).device
    model = build_model(cfg)
    prefill = dec.make_prefill_step(cfg, kernel_fn=kops.spectral_contract)
    step = dec.make_decode_step(cfg)
    S = len(prompt)
    with torch.no_grad():
        cache = model.init_cache(1, S + new - 1, dtype=torch.float32,
                                 device=dev)
        logits, cache = prefill(params, {"tokens": torch.as_tensor(
            prompt[None], dtype=torch.int64, device=dev)}, cache)
        steps = [logits[0, -1].float().cpu()]
        for i in range(new - 1):
            cur = torch.tensor([[int(steps[-1].argmax())]], device=dev)
            logits, _, cache = step(params, cur, cache, S + i)
            steps.append(logits[0, -1].float().cpu())
    lg = torch.stack(steps)
    return lg.argmax(-1).tolist(), lg


def generate_one(engine, prompt, new):
    return engine.generate([Request(prompt=prompt,
                                    max_new_tokens=new)])[0]["tokens"]


def oracle_check(cfg, params, prompt, new):
    """On the card: the B=1 ``Engine`` gives its path's greedy tokens, the
    ``ContinuousEngine`` gives its paged path's, and the two paths agree
    step by step (logits within 1e-4 of their scale, tokens equal up to
    the first near-tie).  Returns (batch trace, comparison)."""
    batch = batch_trace(cfg, params, prompt, new)
    paged = greedy_trace(cfg, params, prompt, new, codec.QuantPolicy(),
                         "stream")
    eng = Engine(cfg, params, max_batch=1, max_seq=len(prompt) + new,
                 device=DEVICE)
    cont = ContinuousEngine(cfg, params, max_slots=2,
                            max_seq=len(prompt) + new, page_size=16,
                            decode_chunk=8, device=DEVICE)
    got = {"engine": generate_one(eng, prompt, new),
           "continuous": generate_one(cont, prompt, new)}
    if got["engine"] != batch[0] or got["continuous"] != paged[0]:
        raise AssertionError(f"engines {got} against their paths "
                             f"{batch[0]} / {paged[0]}")
    # float32 through every layer, attention and MAC lowered differently on
    # the two paths: ~1e-6 of the logit scale, held at 1e-4
    tol = 1e-4 * max(1.0, float(batch[1][0].abs().max()))
    return batch, {"tokens": got, "tol": tol,
                   **compare_traces(batch, paged, tol)}


def phase_batch_parity(cfg):
    cfg = cfg.replace(dtype="float32")
    rng = np.random.RandomState(SEED + 3)
    prompt = rng.randint(0, cfg.vocab_size, size=48).astype(np.int32)
    new = 16
    cpu = precompute_serving_params(
        init_params(cfg, seed=SEED + 3, device="cpu"), cfg)
    card = copy.deepcopy(cpu).to(DEVICE)
    card_trace, vs_continuous = oracle_check(cfg, card, prompt, new)
    cpu_trace = batch_trace(cfg, cpu, prompt, new)
    cpu_tokens = generate_one(Engine(cfg, cpu, max_batch=1, max_seq=64,
                                     device="cpu"), prompt, new)
    if cpu_tokens != cpu_trace[0]:
        raise AssertionError(f"CPU engine {cpu_tokens} against its path "
                             f"{cpu_trace[0]}")
    scale = max(1.0, float(cpu_trace[1][0].abs().max()))
    logit_tol = 1e-4 * scale
    logit_err = max_err(card_trace[1][0], cpu_trace[1][0])
    if not logit_err <= logit_tol:
        raise AssertionError(f"prefill logits differ by {logit_err} > "
                             f"{logit_tol}")
    vs_cpu = compare_traces(card_trace, cpu_trace, logit_tol)
    per_token = generate_one(Engine(cfg, card, max_batch=1, max_seq=64,
                                    decode_mode="per_token", device=DEVICE),
                             prompt, new)
    if per_token != card_trace[0]:
        raise AssertionError(f"per_token {per_token} against scan "
                             f"{card_trace[0]}")
    sampled = [generate_one(Engine(cfg, card, max_batch=1, max_seq=64,
                                   sample=True, seed=seed, device=DEVICE),
                            prompt, new) for seed in (1, 1, 2)]
    if sampled[0] != sampled[1] or sampled[0] == sampled[2]:
        raise AssertionError(f"sampled runs with seeds 1, 1, 2: {sampled}")
    if sampled[0][0] != card_trace[0][0]:
        raise AssertionError("the sampled run's first token is not the "
                             "prefill's argmax")
    out = {"phase": "serve_batch_parity", "dtype": "float32",
           "prompt_len": len(prompt), "new_tokens": new,
           "prefill_logit_max_abs_err": logit_err,
           "prefill_logit_tol": logit_tol, "card_vs_cpu": vs_cpu,
           "engine_vs_continuous": vs_continuous,
           "per_token_equals_scan": True, "sampled_seed1": sampled[0],
           "sampled_seed2": sampled[2], "tokens_card": card_trace[0],
           "tokens_cpu": cpu_trace[0]}
    emit(out)
    return out


def phase_serve_qwen():
    """Each qwen model at its published widths and depth, random weights
    from the seed: 4 requests through each engine (exact launch counts),
    then the B=1 oracle check on one float32 request."""
    out = {}
    for arch in QWEN:
        cfg = get_config(arch)
        L = cfg.num_layers
        per_pass = 7 * L
        params = init_params(cfg, seed=SEED, device=DEVICE)
        rng = np.random.RandomState(SEED)
        warm = make_requests(cfg, 1, 17, 17, 2, rng)
        reqs = make_requests(cfg, 4, 17, 200, 16, rng)
        runs = {}
        engines = {
            "batch": lambda: Engine(cfg, params, max_batch=8, max_seq=256,
                                    device=DEVICE),
            "continuous": lambda: ContinuousEngine(
                cfg, params, max_slots=4, max_seq=256, page_size=16,
                decode_chunk=8, device=DEVICE)}
        for name, make in engines.items():
            make().generate(warm)
            results, st, launches, wall, peak = timed_run(make(), reqs)
            pre, steps = st["prefills"], st["decode_steps"]
            if name == "batch":
                want = batch_launches(cfg, st)
            else:
                want = {"bc_fused": per_pass * (pre + steps),
                        "flash_attention": L * pre,
                        "paged_attention": L * steps}
            check_launches(launches, want)
            tokens = sum(r["decode_len"] for r in results)
            runs[name] = {
                "requests": len(results), "tokens": tokens, "wall_s": wall,
                "tokens_per_s": tokens / wall, "prefill_s": st["prefill_s"],
                "decode_s": st["decode_s"], "prefills": pre,
                "decode_steps": steps,
                "ms_per_step": 1e3 * st["decode_s"] / max(steps, 1),
                "launches": launches, "peak_memory_bytes": peak,
                "cache_or_pool_bytes": st.get("cache_bytes",
                                              st.get("pool_bytes"))}
        prompt = np.random.RandomState(SEED + 4).randint(
            0, cfg.vocab_size, size=48).astype(np.int32)
        _, oracle = oracle_check(cfg.replace(dtype="float32"), params,
                                 prompt, 16)
        out[arch] = {"phase": "serve_qwen", "arch": arch, "layers": L,
                     "d_model": cfg.d_model, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab_size,
                     "prompt_lens": [len(r.prompt) for r in reqs],
                     **runs, "oracle_b1_float32": oracle}
        emit(out[arch])
        del params
        torch.cuda.empty_cache()
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
    # clusters of each size the card runs at once (bc_fused's plan assumes
    # bc_fused.MAX_CLUSTERS; another count makes plans slower, not wrong)
    occ = bc_fused.KERNEL.lib().bc_fused_max_active_clusters
    occ.argtypes, occ.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    clusters = {cs: occ(cs, bc_fused.MAX_SMEM) for cs in bc_fused.MAX_CLUSTERS}
    emit({"phase": "build", "nvcc_s": secs,
          "bc_fused_max_active_clusters": clusters,
          "as_planned": clusters == bc_fused.MAX_CLUSTERS,
          "wall_s": time.perf_counter() - t0,
          "libraries": {n: str(build.library_path(n).relative_to(ROOT))
                        for n in build.KERNEL_NAMES},
          "ptxas": {n: [ln for ln in build.library_path(n).with_suffix(".log")
                        .read_text().splitlines() if "registers" in ln
                        or "spill" in ln]
                    for n in build.KERNEL_NAMES}})
    cfg = get_config(ARCH)
    kernels = phase_kernels(cfg)
    runs = {"serve": phase_serve(cfg)}
    phase_parity(cfg)
    for bits in (8, 4):
        runs[f"serve_quant_int{bits}"] = phase_serve_quant(cfg, bits)
    runs["serve_gather"] = phase_serve_gather(cfg)
    phase_quant_parity(cfg)
    runs["serve_batch"] = phase_serve_batch(cfg)
    phase_serve_batch_quant(cfg)
    phase_batch_parity(cfg)
    phase_serve_qwen()
    phase_lowering(cfg, kernel_gen())
    summary = []
    for name, (lib, replaces, group, main_case, run) in LANES.items():
        cases, _ = kernels[group]
        c = next(c for c in cases if c["case"] == main_case)
        launches = runs[run]["launches"][name]
        if not launches:
            raise AssertionError(f"{name}: no launch in the {run} run")
        summary.append({
            "name": name, "route": "cuda",
            "source": str(lib.source.relative_to(ROOT)),
            "replaces": replaces, "launches": launches, "launches_in": run,
            "case": main_case, "max_abs_err": c["max_abs_err"],
            "tol": c["tol"], "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
            "device_ms": c["device_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
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
