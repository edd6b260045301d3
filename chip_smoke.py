#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py

It imports neither ``jax`` nor ``repro``; it puts ``src/`` on ``sys.path``
itself.  Each phase prints one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi)
  build         nvcc time and library paths of the five CUDA libraries
  kernels       each kernel lane against its plain PyTorch version on the
                card, at the full-width tinyllama-1.1b shapes of the serving
                paths: error and tolerance, kernel / plain / library times
                (median of CUDA-event timings; the kernel also replayed
                from a CUDA graph, its device time), the roofline bound
  serve_smoke   the serve launcher's default: each of the ten archs' smoke
                configs (bf16, head dim 32, weights from the seed) through
                the batch ``Engine`` and, for the five paged archs,
                ``ContinuousEngine``, 4 requests of 4 tokens, the card's
                bf16 logits against the same engine on the CPU; the bf16
                flash lane and the paged kernel at D = 32 counted; then
                ``python -m repro_torch.launch.serve --arch tinyllama-1.1b``
                (exit 0)
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
  serve_phi3    phi-3-vision-4.2b (the vision stub: 576 zero patch
                embeddings replace the first prompt slots; 32 heads of 96)
                at its published widths and depth: 4 requests of 600-760
                tokens through both engines (exact launch counts; every
                prefill on the bf16 flash lane at head dim 96), the B=1
                oracle check on one float32 request of 600 + 16 tokens
                (its prefills on the float32 tensor-core flash kernel;
                the launches of every oracle check are counted)
  serve_moe     llama4-maverick-400b-a17b (48 layers alternating dense and
                mixture-of-experts, 128 experts top-1 plus a shared expert)
                at its published widths and depth: 4 requests of 17-64
                tokens through both engines (exact launch counts: each of
                the three expert projections one launch of ``bc_fused``
                over all 128 experts per MoE layer and forward pass), the
                B=1 oracle check on one
                float32 request of 48 + 8 tokens with the smallest gap
                between the two largest router logits it met; peak device
                memory and the phase's wall time
  serve_fused   tinyllama-1.1b with ``fuse_projections``: the serve phase's
                16 requests through both engines on float32, int8 and int4
                planes (an int8 pool): 88 ``bc_fused`` launches a forward
                pass (q/k/v and up/gate one launch each), the batch
                prefill's MAC through ``spectral_matmul`` at P = 20 and 88,
                plane bytes equal to the unfused engine's; then one float32
                request of each of the five archs fused against unfused on
                the same weights (llama4's re-baked in place): prefill
                logits within 1e-4 of their scale, greedy tokens equal up to
                the first near-tie
  serve_mixtral, serve_xlstm, serve_whisper, serve_gemma2,
  serve_recurrentgemma  the archs only the batch
                ``Engine`` serves, at their published widths and depth
                after a one-request warm-up: mixtral-8x7b (32 layers of
                sliding-window attention over a ring cache of 4,096 slots,
                8 experts top-2; 4 requests of 4,096-4,200 + 8 tokens),
                xlstm-125m (12 mLSTM / sLSTM cells; 4 of 17-200 + 16),
                whisper-large-v3 (32 encoder layers over 1,500 zero frames,
                32 decoder layers with cross-attention over the cached
                encoder K/V; 4 of 17-200 + 16), gemma2-9b (42 layers
                alternating a window of 4,096 (ring) and global attention
                (linear cache), head dim 256, softcaps 50 / 30, sandwich
                norms; 4 of 4,096-4,200 + 8) and recurrentgemma-2b (26
                layers, 18 RG-LRU and 8 windowed over a ring of 2,048, G =
                10 at head dim 256; 4 of 2,048-2,150 + 16): exact launch
                counts per lane (the encoder and cross K/V once a
                prefill), tokens/s,
                prefill and step times, cache and peak bytes; the B=1
                float32 oracle equal to a hand-run ``batch_trace``; and at
                one group of the layer pattern (full width) the card's
                float32 prefill logits within 1e-4 of their scale of the
                CPU's plain path
  serve_obs     tinyllama-1.1b through ``ContinuousEngine`` with the
                telemetry plane on (``repro_torch.obs``): int8 planes and
                pool, a JSONL file, the stock SLO rules, a Chrome trace and
                the shadow oracle on every finished request (4 requests of
                17-200 + 16): both files valid under the port's
                validators, the health histograms non-empty and finite,
                the shadow agreement, each dispatch kind's roofline
                fraction on the ``h100`` spec in (0, 1], greedy tokens
                equal with obs off; then the plane's cost, tokens/s of
                obs disabled / ``capture=False`` / on over 8 requests of
                17-200 + 32 in ``OBS_ROUNDS`` paired rounds (``serve_batch``
                also checks its fractions; ``train`` validates its
                ``--metrics-out`` file)
  serve_chaos   fault injection (``serve/faults.py:run_chaos``'s schedule:
                24 requests a seed with randomized deadlines, cancels,
                allocator failures, dispatch delays and NaN-poisoned
                slots) at tinyllama-1.1b's full width and depth in
                float32: ``CHAOS_SEEDS`` on an f32 pool and the first on
                an int8 pool; the chaos invariants (one terminal each, no page
                leak, the B=1 oracle's tokens up to a near-tie, the health
                plane sees every guard trip), one decode capture a run
  serve_fleet   two replicas sharing the weights behind the failover
                router (``run_fleet_chaos``): one crashed mid-serving, one
                hanging now and then; every request settles once, the
                survivor's pool is restored, migrated requests finish with
                the oracle's tokens, step timeouts only at injected hangs
  conv          the paper's block-circulant CONV layer (``core/conv.py``)
                at cifar_wrn's three 3x3 widths, batch 128, block 16:
                forward and both gradients through ``bc_fused`` and
                ``bc_grad_w`` against the plain path and ``F.conv2d`` on
                the materialized filter, times and bounds, each kernel at
                the layer's shapes against its plain version; then the
                same at block 4 (the kernels' DFT panel padded to 8,
                ``bc_grad_w``'s plain-DFT path)
  block_sizes   tinyllama-1.1b at full width and depth with every
                projection at block size 256 and then 4 (``--block-size``,
                repro's hillclimb override): the continuous and the batch
                engine (its prefill MAC through spectral_matmul at F = 129
                bins at 256, through bc_fused at 4, as its
                ``prefill_lanes`` say), 4
                requests each with exact launch counts, the B=1 oracle
                check, 3 training steps of 4 x 512 tokens with launches by
                shape; ``bc_fused`` (every lane at B = 8, the training
                rows) and ``bc_grad_w`` at these k against their plain
                versions
  serve_kvf8    tinyllama-1.1b, float32, through the batch ``Engine``
                over a float8_e4m3fn dense cache: 4 requests of 64 + 16,
                every decode attention on flash's e4m3 rows lane, the
                engines equal to their paths, each row against the B=1
                oracle over the same cache up to the first near-tie, the
                float8 oracle beside the float32 cache's; the e4m3 lane
                against its plain version
  decode_graph  the continuous engine's decode loop replayed from its CUDA
                graph against the same loop run eagerly, on the f32 and
                bf16 pools (stream), the gather path and the int8 pool,
                greedy and sampled: tokens, positions, budgets, pool bytes
                (but the trash page's) and launch counts equal; capture count and seconds; a step
                that reads the card inside fails to capture and raises

  train         tinyllama-1.1b at full width and depth through
                ``repro_torch.launch.train --full``: 8 AdamW steps of 8 x
                1,024 tokens, bf16 activations, remat, random weights from
                the seed; every loss finite, no step skipped, ms per step
                (the median of steps 3-8), tokens/s, peak memory, and the
                ``bc_fused`` / ``bc_grad_w`` launches a step by shape equal
                to those derived from the model (the forward twice under
                remat, then one adjoint and one weight gradient a
                projection; no other kernel)
  train_parity  the same at 2 layers in float32: the card's loss and every
                parameter's gradient against the CPU's plain path on the
                same weights and batch; then the ``Trainer`` on the card,
                one step, a checkpoint, a restore and step 2, equal bit for
                bit to two uninterrupted steps
  train_dense   ``--no-compress`` at the same shape and depth, 4 steps: ms
                per step and peak memory beside the circulant run's
  train_mixtral, train_llama4, train_gemma2, train_recurrentgemma,
  train_xlstm, train_whisper  the other six archs through the launcher
                at their published widths (``TRAIN_ARCHS``): mixtral (32
                layers, 2 x 4,608 tokens, past its window of 4,096),
                llama4 cut to 8 layers (four attn / moe groups; 8 x 1,024),
                gemma2 (42 layers, 2 x 4,608), recurrentgemma (26, 2 x
                2,560, past its 2,048), xlstm (12, 8 x 1,024), whisper (32
                + 32, 8 x 448 decoder tokens over 1,500 frames); 3 AdamW
                steps each, bf16, remat, no checkpoints: losses (and the
                MoE aux) finite, no step skipped, ms a step, tokens/s, peak
                memory, and the launches a step by lane, path and shape
                equal to those the model calls for (``train_expected``:
                each expert stack one ``bc_fused`` launch a projection and
                pass and one ``bc_grad_w`` call a projection)
  train_parity  (again, one line per arch above) 2 layers (whisper 2 + 2)
                at published widths, float32, 2 x 64 tokens: the card's
                loss, aux and every gradient against the CPU's plain path
  dist          ``launch/mesh.py:make_host_mesh()``'s one-rank NCCL mesh:
                ``wire_allreduce_int8`` over tinyllama-1.1b's gradients
                against the CPU's int8 round trip, ``Engine(mesh=)``'s
                tokens equal to the default's, the rule engine's bytes a
                device of a (16, 16) duck mesh would hold of tinyllama's
                parameters and planes; the process group destroyed
  nogauss       tinyllama-1.1b at full width and depth with
                ``gauss_trick=False`` (the paper's own MAC): every
                projection on ``bc_fused``'s 4-product lanes through both
                engines (f32 planes; the continuous engine also on int8
                and int4), exact launch counts, the batch prefill's MAC on
                the fused kernel with the planner's reason; one float32
                request against the CPU's plain path; 3 training steps of
                4 x 512 tokens, the forward and adjoint on the lane
  dryrun        ``repro_torch.launch.dryrun`` in nine subprocesses at
                once, started after the last timed phase (the card hidden
                from them), each trace taking the card's path (every
                kernel launch a stand-in, ``kernels/standin.py``):
                tinyllama-1.1b x every shape
                on the (16, 16) and (2, 16, 16) meshes, llama4 x
                decode_32k, recurrentgemma-2b and xlstm-125m x long_500k,
                every cell ok but tinyllama's long_500k (skipped with
                repro's reason): bytes a device against the card's memory,
                FLOPs, collective bytes, the dominant term on the ``h100``
                spec and the launches a device makes, as predictions; then
                three one-rank records against the same steps on the card
                at full width and depth: recurrentgemma-2b x long_500k
                (decode), tinyllama-1.1b x prefill_32k through the batch
                engine's prefill and one tinyllama-1.1b x train_4k step,
                their batches cut (``DRYRUN_ONE``): argument bytes equal,
                new bytes within ``DRYRUN_PEAK_TOL`` of the rise of
                ``max_memory_allocated``, launches per lane, path and
                shape equal

Every ``ContinuousEngine`` above decodes by replaying the CUDA graph of its
step, captured when the engine is built (``serve/decode.py``); its launch
counts are the replays' (warm-up and capture are counted apart).

The kernels phase also holds the 4-product lanes (``bc_fused4``, int8,
int4) at tinyllama's up/gate (B = 8; 2,048 rows; an 8-expert stack of 4
rows, each expert bit-equal to its single call; the adjoint at 2,048
rows) to their plain version, dense ``torch.matmul`` their library.

The kernels phase adds ``spectral_matmul`` at every batch-prefill shape
(F = 65, N = 2048 rows) in both of its layouts (``repro``'s contiguous
one, and the hook's views: cases ending ``_hook``), each also repeated
and replayed from a CUDA graph for the same bits, the whole projection at those shapes under three
lowerings (the hook, ``bc_fused``, dense ``torch.matmul``), the flash kernel
at the dense-decode shape, and ``bc_fused`` / ``paged_attention`` / the
flash kernel (head dim 128: bf16 prefill, float32 one-row decode) at qwen's
shapes, the same at phi-3-vision's head dim 96 (bf16 prefill at 640
positions; the float32 one-row decode and ``paged_attention`` on both pool
lanes, at its 32 KV heads (G = 1), at the shapes of serve_phi3's last
decode step: 4 rows over 775 keys, 4 slots of 64-page tables at
positions 614-774), ``bc_fused`` on all three lanes at llama4's
projection and expert shapes (4 rows) and phi-3-vision's, and llama4's
expert stack (128 experts of 4 rows, up/gate) in one launch on each lane,
held bit for bit to the per-expert loop and to its CUDA-graph replay.
Then the shapes of the batch-only archs, each as their batch run or
float32 oracle launches it: flash over whisper's 1,500 frames
(bidirectional, bf16 at 4 requests and float32 at 1), its
cross-attention (a 4 x 200 row prefill and a one-row decode over 1,500
keys), mixtral's windowed prefill (window 4,096: bf16 at 4 x 4,200, held
to the plain version one row at a time, and float32 at 1 x 4,100) and
ring decode (4 rows over the 4,089 keys of the last step); ``bc_fused``
at whisper's and xlstm's decode projections and mixtral's expert stack
(8 experts of 4 rows, all three lanes); ``spectral_matmul`` at whisper's
encoder rows (N = 6,000).  At head dim 256 every flash lane at the shapes
serve_gemma2 and serve_recurrentgemma give it (``check_head_dim_256``),
``bc_fused`` at their decode projections and ``spectral_matmul`` at their
prefill rows (N = 16,800 and 8,600).  Their summary entries count the
launches of that one shape (``Kernel.shape_launches``).
Every flash case without a logit softcap times
``F.scaled_dot_product_attention`` under each of its backends and takes
the one ``SDPA_PINNED`` names as its library time; no SDPA call computes
a softcap, so gemma2's cases time one compiled ``flex_attention`` call
(``flex_library``);
The training kernels: ``bc_grad_w`` at each of tinyllama's training
shapes (q/o, k/v, up/gate, down and the fused q/k/v and up/gate, N = 8 x
1,024 rows) against its plain version, two calls bit-equal, its library
time one complex64 ``torch.bmm`` over the bins (the contraction alone),
and the whole function as three library calls (``torch.fft.rfft`` of
both inputs, that ``torch.bmm``, ``torch.fft.irfft``: ``library_whole_ms``);
``bc_fused`` at the training rows at every forward and adjoint shape.
The expert stacks of the MoE train phases (``check_train_stacks``):
``bc_grad_w``'s stack lane at mixtral's (8 experts of 2,880 rows) and
llama4's (128 of 80) up/gate and down, and ``bc_fused``'s stack forward
and adjoint at their up/gate, each expert equal bit for bit to the
single call on its rows, with the library times of row 6 (complex64
``torch.bmm`` over E x kf bins; rfft, bmm, irfft) and of a dense bmm.
``paged_attention`` also with one slot idle where none is (cases ending
``_idle``) and with every slot at the table's last column (``_full``).
Each case carries its launch plan where the kernel has one, and
``bound_share`` = bound / device time.

Then the card's name and power limit, the kernel summary
``{"kernels": [...]}`` (one entry per lane), and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code not 0, no last line); so does a machine
without a CUDA device.
"""
from __future__ import annotations

import atexit
import copy
import ctypes
import gc
import json
import math
import shutil
import statistics
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_smoke_config)
from repro_torch.core import circulant as cc  # noqa: E402
from repro_torch.core import conv  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import bc_fused, build  # noqa: E402
from repro_torch.kernels import bc_grad_w as bgw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged as pg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import spectral_matmul as sm  # noqa: E402
from repro_torch.kernels import standin  # noqa: E402
from repro_torch.launch import dryrun as dryrun_lib  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.layers import attention as attn_lib  # noqa: E402
from repro_torch.layers import ffn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.registry import build_model, init_params  # noqa: E402
from repro_torch.models.transformer import layer_kinds, window_for  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs.chrometrace import validate_trace, write_trace  # noqa: E402
from repro_torch.obs.emit import last_snapshot, validate_jsonl  # noqa: E402
from repro_torch.obs.slo import SloWatchdog, default_rules  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
# the peak rates of one H100 SXM (NVIDIA data sheet, 700 W) and the least
# time for a kernel's work on them
from repro_torch.roofline.analysis import H100, bound  # noqa: E402
from repro_torch.serve import decode as dec  # noqa: E402
from repro_torch.serve import faults  # noqa: E402
from repro_torch.serve import kvcache as kvc  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      PrefillContract, Request,
                                      frontend_inputs)
from repro_torch.serve.params import precompute_serving_params  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "tinyllama-1.1b"
SEED = 0
DEVICE = "cuda"
LIBRARIES = (bc_fused.KERNEL, fa.KERNEL, pa.KERNEL, pg.KERNEL, sm.KERNEL)
# the training phases count bc_grad_w too (the serving phases' launch
# fields stay as they were)
TRAIN_LIBRARIES = LIBRARIES + (bgw.KERNEL,)
# train: tinyllama-1.1b at full width and depth, 8 x 1,024 tokens a step
TRAIN = dict(batch=8, seq=1024, steps=8, dense_steps=4)
TRAIN_ROWS = TRAIN["batch"] * TRAIN["seq"]
QWEN = ("qwen2.5-3b", "qwen3-4b")
PHI3, MOE = "phi-3-vision-4.2b", "llama4-maverick-400b-a17b"
MIXTRAL, XLSTM, WHISPER = "mixtral-8x7b", "xlstm-125m", "whisper-large-v3"
GEMMA2, RGEMMA = "gemma2-9b", "recurrentgemma-2b"
ROWS = 8 * 256              # batch-prefill rows: 8 prompts padded to 256
# serve_arch's requests and engine sizes for serve_phi3 / serve_moe (4
# requests; ContinuousEngine with SLOTS slots and pages of PAGE).  The
# kernels phase checks phi-3's decode attention at the shapes they give.
SERVE_ARCH = {
    PHI3: dict(lo=600, hi=760, new=16, max_seq=1024, oracle_len=600,
               oracle_new=16),
    MOE: dict(lo=17, hi=64, new=8, max_seq=128, oracle_len=48,
              oracle_new=8)}
SLOTS, PAGE = 4, 16
# serve_batch_arch's requests and sizes for the archs only the batch engine
# serves: 4 requests of lo-hi prompt tokens (mixtral's and gemma2's cover
# their window of 4,096, recurrentgemma's its 2,048, as their ring caches
# require) and ``new`` new tokens; the B=1 float32 oracle of oracle_len +
# oracle_new; the card-against-CPU check at the depth ``reduced`` (one
# group of the layer pattern, full width) on a prompt of check_len tokens
BATCH_ARCH = {
    MIXTRAL: dict(lo=4096, hi=4200, new=8, max_seq=4224, oracle_len=4100,
                  oracle_new=8, reduced=dict(num_layers=2), check_len=64),
    XLSTM: dict(lo=17, hi=200, new=16, max_seq=256, oracle_len=48,
                oracle_new=16, reduced=dict(num_layers=3), check_len=64),
    WHISPER: dict(lo=17, hi=200, new=16, max_seq=256, oracle_len=48,
                  oracle_new=16, reduced=dict(num_layers=2,
                                              encoder_layers=2),
                  check_len=48),
    GEMMA2: dict(lo=4096, hi=4200, new=8, max_seq=4224, oracle_len=4100,
                 oracle_new=8, reduced=dict(num_layers=2), check_len=64),
    RGEMMA: dict(lo=2048, hi=2150, new=16, max_seq=2176, oracle_len=2100,
                 oracle_new=8, reduced=dict(num_layers=3), check_len=64)}
# the train phases of the archs past attn blocks: the launcher at the
# published widths, ``batch`` x ``seq`` tokens a step (mixtral's and
# gemma2's past their window of 4,096, recurrentgemma's past its 2,048),
# ``steps`` AdamW steps, bf16, remat; ``layers`` cuts the depth (llama4 at
# full depth is ~4.15 B float32 parameters: embedding 1.03 B, 24 expert
# stacks of 126 M; its parameters, gradients and moments alone would
# take ~66 GB); whisper's ``seq`` is its decoder tokens over 1,500 frames
TRAIN_ARCHS = {
    MIXTRAL: dict(phase="train_mixtral", batch=2, seq=4608, steps=3),
    MOE: dict(phase="train_llama4", batch=8, seq=1024, steps=3, layers=8),
    GEMMA2: dict(phase="train_gemma2", batch=2, seq=4608, steps=3),
    RGEMMA: dict(phase="train_recurrentgemma", batch=2, seq=2560, steps=3),
    XLSTM: dict(phase="train_xlstm", batch=8, seq=1024, steps=3),
    WHISPER: dict(phase="train_whisper", batch=8, seq=448, steps=3)}


# serve_smoke: the serve launcher's default (``python -m
# repro_torch.launch.serve --arch A``: the smoke config, bf16, block 16,
# head dim 32, weights from the seed) for each of the ten archs, through
# the batch Engine and, where the arch is continuous-servable, the
# ContinuousEngine, at the launcher's engine sizes; ``requests`` requests
# of ``new`` tokens, prompts drawn as the launcher draws them
SMOKE = dict(requests=4, new=4, max_batch=4, page=16, chunk=8)
# the card's bf16 logits against the CPU engine's on the same weights, a
# share of max(1, |CPU logits|): both compute in bf16 with float32 sums
# and round at other places (the card's flash kernel rounds P to bf16 for
# P V; the plain version keeps it in float32)
SMOKE_LOGIT_TOL = 2.0 ** -4
# the new lanes at public models' widths (no config of the port reaches
# them: every full-size attention head is 64, 96, 128 or 256): phi-2's 32
# heads of 80; a head of 192 (16 / 8 heads) on both float32 kernels;
# paged decode at 256 (8 slots, 8 / 1 heads, 64-page tables of 16) and
# Falcon-7B's 71 query heads over one KV head of 64
NEW_LANES = dict(s=2048, b32=4, h32=32, phi2=(32, 32, 80),
                 d192=(16, 8, 192), skv=4096, paged_b=8, paged_maxp=64,
                 d256=(8, 1, 256), g71=(71, 1, 64))
NEW_LANE_POSITIONS = (1000, 17, 63, -1, 530, 5, 1023, 795)


BLOCK_SIZES = (256, 4)
# block_sizes: tinyllama-1.1b at full width and depth with every attention
# and FFN projection at block size k (repro's hillclimb override); ``n``
# requests of ``lo``-``hi`` + ``new`` tokens through each engine (8 slots:
# the continuous step's B), the B=1 float32 oracle on one request of
# ``oracle_len`` + ``oracle_new``, and ``steps`` training steps of ``batch``
# x ``seq`` tokens through the launcher
BLOCK_SERVE = dict(n=4, lo=17, hi=64, new=8, max_seq=128, oracle_len=32,
                   oracle_new=8)
BLOCK_TRAIN = dict(batch=4, seq=512, steps=3)
BLOCK_ROWS = BLOCK_TRAIN["batch"] * BLOCK_TRAIN["seq"]
# serve_kvf8: B requests of one length (no padding, so each row of the
# batch is the B=1 path's request) over a float8_e4m3fn dense cache
KVF8 = dict(B=4, S=64, new=16)
# nogauss (the paper's 4-product MAC, gauss_trick=False): 4 requests of
# 17-64 + 8 tokens through each engine, int8 and int4 planes through the
# continuous one, the float32 card-vs-CPU parity, 3 training steps of 4 x
# 512 tokens
NOGAUSS = dict(n=4, lo=17, hi=64, new=8, max_seq=128)
# dryrun: each job one process of repro_torch.launch.dryrun (arch, shape,
# mesh, further arguments), all at once on the host's cores after the last
# timed phase; "one" is the 1-rank mesh whose records the card checks hold
# to the card: recurrentgemma-2b's long_500k decode (dryrun_card_check),
# and tinyllama-1.1b's prefill_32k through the batch engine's prefill and
# one train_4k step (dryrun_one_check), each with its batch cut to
# DRYRUN_ONE's rows (the record states the cut; the train step takes one
# batch, --roofline, as the card's step with accum=1)
DRYRUN_ONE = {"prefill_32k": dict(batch=4, accum=4),
              "train_4k": dict(batch=2, accum=0)}
DRYRUN_JOBS = (("tinyllama-1.1b", "train_4k", "single", ()),
               ("tinyllama-1.1b", "prefill_32k,decode_32k,long_500k",
                "single", ()),
               ("tinyllama-1.1b", "train_4k", "multi", ()),
               ("tinyllama-1.1b", "prefill_32k,decode_32k,long_500k",
                "multi", ()),
               ("llama4-maverick-400b-a17b", "decode_32k", "single", ()),
               ("recurrentgemma-2b,xlstm-125m", "long_500k", "single", ()),
               ("recurrentgemma-2b", "long_500k", "one", ()),
               *((ARCH, shape, "one",
                  ("--batch", str(kw["batch"]))
                  + (("--roofline",) if kw["accum"] == 0 else ()))
                 for shape, kw in DRYRUN_ONE.items()))
DRYRUN_TIMEOUT = 300
# a one-rank record's new bytes against the card's rise of
# max_memory_allocated over the same step: the allocator rounds every block
# up to 512 bytes; the trace takes each kernel's card branch (its output
# and scratch, the flash kernel's split-KV partials among them) and keeps
# what the card runs as plain PyTorch
DRYRUN_PEAK_TOL = dict(rel=0.05, abs=16 << 20)
NOGAUSS_TRAIN = dict(batch=4, seq=512, steps=3)
# serve_kvf8's limit on a batch row's step logits against the B=1 oracle
# over the same float8 cache, a fraction of the logit scale (4.2 on the
# H100): between the largest reading of sound runs (6.7e-4, a code flipped
# at an e4m3 midpoint) and the controls' (the oracle over a float32 or a
# bfloat16 cache: 3.9e-2 and 3.5e-2), which the phase checks stay above it
KVF8_TOL = 1e-2


def ring_decode_keys(S, steps, window):
    """The keys a ring read hands the flash kernel at the last of
    ``steps`` decode steps after a prefill of S positions: the ring's
    slot rules (``layers/attention.py``) replayed on a host ``pos`` row of
    min(window, S + steps) slots, then the slots ``ring_runs`` keeps.
    Each decode step overwrites a position the window still holds, so the
    count falls by one a step (mixtral's 4,095 .. 4,089 at S = 4,200)."""
    smax = min(window, S + steps)
    pos = torch.arange(S - smax, S, dtype=torch.int32)
    for p in range(S, S + steps):
        pos[p % smax] = p
    return sum(b - a for a, b in attn_lib.ring_runs(pos, S + steps - 1,
                                                    window))


# the keys of each windowed batch-only arch's last ring decode step
RING_KEYS = {arch: ring_decode_keys(
    BATCH_ARCH[arch]["hi"], BATCH_ARCH[arch]["new"] - 1,
    get_config(arch).attention.sliding_window)
    for arch in (MIXTRAL, GEMMA2, RGEMMA)}
# gemma2's global layers at its batch run's last decode step: one row over
# the cache's first hi + new - 1 positions
GLOBAL_KEYS = BATCH_ARCH[GEMMA2]["hi"] + BATCH_ARCH[GEMMA2]["new"] - 1
# head dim 256 (serve_gemma2 / serve_recurrentgemma), each flash lane at
# the shape its run launches it: gemma2's windowed (local) and global
# layers with softcap 50, recurrentgemma's window of 2,048 at G = 10; the
# batch runs' prefills (bf16) and last decode steps, the float32 oracles'
# prefills.  (summary entry suffix, kernels-phase case, run, plan path)
D256 = (
    ("window_prefill", "gemma2_prefill_bfloat16_b4_s4200_w4096",
     f"{GEMMA2}/batch", "bf16"),
    ("prefill", "gemma2_prefill_bfloat16_b4_s4200", f"{GEMMA2}/batch",
     "bf16"),
    ("window_prefill_f32", "gemma2_prefill_float32_s4100_w4096",
     f"{GEMMA2}/oracle", "f32_mma"),
    ("prefill_f32", "gemma2_prefill_float32_s4100", f"{GEMMA2}/oracle",
     "f32_mma"),
    ("decode", f"gemma2_decode_float32_b4_skv{GLOBAL_KEYS}",
     f"{GEMMA2}/batch", "f32_rows"),
    ("ring_decode", f"gemma2_ring_decode_float32_b4_skv{RING_KEYS[GEMMA2]}",
     f"{GEMMA2}/batch", "f32_rows"),
    ("g10_window_prefill", "recurrentgemma_prefill_bfloat16_b4_s2150_w2048",
     f"{RGEMMA}/batch", "bf16"),
    ("g10_window_prefill_f32", "recurrentgemma_prefill_float32_s2100_w2048",
     f"{RGEMMA}/oracle", "f32_mma"),
    ("g10_ring_decode",
     f"recurrentgemma_ring_decode_float32_b4_skv{RING_KEYS[RGEMMA]}",
     f"{RGEMMA}/batch", "f32_rows"))
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
    # bc_fused's 4-product lanes (gauss_trick=False, the paper's MAC), on
    # the main path in the nogauss phase
    "bc_fused4": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                  "bc_fused4", "up_gate_b8", "nogauss"),
    "bc_fused4_i8": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                     "bc_fused4_i8", "up_gate_b8", "nogauss_int8"),
    "bc_fused4_i4": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                     "bc_fused4_i4", "up_gate_b8", "nogauss_int4"),
    # no Pallas kernel: the weight-gradient half of repro's hand-derived
    # block-circulant backward, which repro leaves to XLA
    "bc_grad_w": (bgw.KERNEL,
                  "src/repro/core/circulant.py:247 (_bc_fft_bwd, XLA)",
                  "bc_grad_w", f"tinyllama_up_gate_n{TRAIN_ROWS}", "train"),
}
# The lanes again at the shapes phi-3-vision and llama4 bring (head dim
# 96, G = 1, expert blocks), named ``<lane>@<shape>``; launches from that
# arch's run in serve_phi3 / serve_moe (the decode cases at that run's
# last decode step: see ``decode_shapes``), counted on the kernel path
# ``SHAPE_PATHS`` names where it names one (beside the lane's total).
NEW_SHAPES = {
    "flash_attention@d96": (fa.KERNEL,
                            "src/repro/kernels/flash_attention.py:75",
                            "flash_attention", "phi3_prefill_bfloat16_s640",
                            f"{PHI3}/continuous"),
    "flash_attention@d96_decode": (fa.KERNEL,
                                   "src/repro/kernels/flash_attention.py:75",
                                   "flash_attention",
                                   "phi3_decode_float32_b4_skv775",
                                   f"{PHI3}/batch"),
    "paged_attention@d96_g1": (pa.KERNEL,
                               "src/repro/kernels/paged_attention.py:181",
                               "paged_attention", "phi3_decode_bfloat16_b4",
                               f"{PHI3}/continuous"),
    "bc_fused@expert": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                        "bc_fused", "llama4_expert_up_gate_b4",
                        f"{MOE}/continuous"),
    # the float32 prefill on the tensor cores at serve_phi3's oracle prompt
    # (launches: the B=1 oracle check's run), and the expert stack in one
    # launch at serve_moe's decode shape
    "flash_attention@d96_prefill_f32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "phi3_prefill_float32_s600", f"{PHI3}/oracle"),
    "bc_fused@experts": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                         "bc_fused", "llama4_experts_up_gate_e128_c4",
                         f"{MOE}/continuous"),
    # projection fusion (serve_fused): q/k/v and up/gate as one projection
    # in the continuous engine's decode (B = 8), and the batch prefill's MAC
    # at their P; launches are the lane's in that run
    "bc_fused@fused_qkv": (bc_fused.KERNEL,
                           "src/repro/kernels/bc_fused.py:48", "bc_fused",
                           "tinyllama_fused_qkv_b8", "serve_fused"),
    "bc_fused@fused_up_gate": (bc_fused.KERNEL,
                               "src/repro/kernels/bc_fused.py:48",
                               "bc_fused", "tinyllama_fused_up_gate_b8",
                               "serve_fused"),
    "spectral_matmul@fused_qkv": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul", "tinyllama_fused_qkv_n2048", "serve_fused_batch"),
    "spectral_matmul@fused_up_gate": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul", "tinyllama_fused_up_gate_n2048",
        "serve_fused_batch"),
    # the batch-only archs (serve_mixtral / serve_xlstm / serve_whisper):
    # launches from that arch's batch-engine run, or its float32 oracle,
    # counted at the case's own shape (``launch_shape``; the plan path's
    # and the lane's counts beside it)
    "flash_attention@encoder": (fa.KERNEL,
                                "src/repro/kernels/flash_attention.py:75",
                                "flash_attention",
                                "whisper_encoder_bfloat16_b4_s1500",
                                f"{WHISPER}/batch"),
    "flash_attention@encoder_f32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "whisper_encoder_float32_b1_s1500",
        f"{WHISPER}/oracle"),
    "flash_attention@cross_prefill": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "whisper_cross_prefill_float32_b4_s200_skv1500",
        f"{WHISPER}/batch"),
    "flash_attention@cross_decode": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "whisper_cross_decode_float32_b4_skv1500",
        f"{WHISPER}/batch"),
    "flash_attention@window_prefill": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "mixtral_prefill_bfloat16_b4_s4200_w4096",
        f"{MIXTRAL}/batch"),
    "flash_attention@window_prefill_f32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", "mixtral_prefill_float32_s4100_w4096",
        f"{MIXTRAL}/oracle"),
    "flash_attention@ring_decode": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention",
        f"mixtral_ring_decode_float32_b4_skv{RING_KEYS[MIXTRAL]}",
        f"{MIXTRAL}/batch"),
    "bc_fused@whisper": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                         "bc_fused", "whisper_up_b4", f"{WHISPER}/batch"),
    "bc_fused@xlstm": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                       "bc_fused", "xlstm_qkv_b4", f"{XLSTM}/batch"),
    "bc_fused@experts_e8": (bc_fused.KERNEL,
                            "src/repro/kernels/bc_fused.py:48", "bc_fused",
                            "mixtral_experts_up_gate_e8_c4",
                            f"{MIXTRAL}/batch"),
    "spectral_matmul@encoder": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul", "whisper_up_n6000_hook", f"{WHISPER}/batch"),
    # head dim 256 (``D256``), counted at the case's shape
    **{f"flash_attention@d256_{name}": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", case, run) for name, case, run, _ in D256},
    # their projections at the batch runs' decode (4 rows) and prefill
    # (the hook's views, 4 x 4,200 and 4 x 2,150 rows)
    "bc_fused@gemma2": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                        "bc_fused", "gemma2_up_gate_b4", f"{GEMMA2}/batch"),
    "bc_fused@recurrentgemma": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48", "bc_fused",
        "recurrentgemma_q_o_b4", f"{RGEMMA}/batch"),
    "spectral_matmul@gemma2": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul", "gemma2_up_gate_n16800_hook", f"{GEMMA2}/batch"),
    "spectral_matmul@recurrentgemma": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul", "recurrentgemma_q_o_n8600_hook",
        f"{RGEMMA}/batch"),
    # training (phase train, N = 8,192 rows): up/gate's forward shape (44,
    # 16), which down's adjoint shares; k/v's adjoint (16, 2), launched by
    # the input gradient alone; counted at the case's shape
    "bc_fused@train": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                       "bc_fused", f"train_up_gate_b{TRAIN_ROWS}", "train"),
    "bc_fused@train_adjoint": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48", "bc_fused",
        f"train_k_v_adjoint_b{TRAIN_ROWS}", "train"),
    # training an expert stack (train_mixtral, train_llama4): bc_fused's
    # stack forward at mixtral's up/gate (down's adjoint shares the
    # shape) and its adjoint at up/gate's (down's forward shape), and the
    # bc_grad_w stack lane at both archs' up/gate; counted at the case's
    # shape on the experts path
    "bc_fused@experts_train": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48", "bc_fused",
        "train_mixtral_up_gate_e8_c2880", "train_mixtral"),
    "bc_fused@experts_train_adjoint": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48", "bc_fused",
        "train_mixtral_up_gate_adjoint_e8_c2880", "train_mixtral"),
    "bc_grad_w@experts_mixtral": (
        bgw.KERNEL, "src/repro/layers/ffn.py:106-111 (jax.vmap of "
        "bc_matmul_fft; _bc_fft_bwd's gw, XLA)", "bc_grad_w",
        "mixtral_up_gate_e8_c2880", "train_mixtral"),
    "bc_grad_w@experts_llama4": (
        bgw.KERNEL, "src/repro/layers/ffn.py:106-111 (jax.vmap of "
        "bc_matmul_fft; _bc_fft_bwd's gw, XLA)", "bc_grad_w",
        "llama4_up_gate_e128_c80", "train_llama4"),
    # the paper's CONV layer (phase conv) at cifar_wrn's g2 (128 x 16 x 16
    # rows, 320 -> 320 channels, block 16): its forward, its input
    # gradient's adjoint and its weight gradient, counted at the case's
    # shape in the layer's run
    "bc_fused@conv": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                      "conv_bc_fused", "conv_g2_forward", "conv"),
    "bc_fused@conv_adjoint": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
        "conv_bc_fused", "conv_g2_adjoint", "conv"),
    "bc_grad_w@conv": (
        bgw.KERNEL, "src/repro/core/circulant.py:247 (_bc_fft_bwd, XLA)",
        "conv_bc_grad_w", "conv_g2", "conv"),
    # the CONV layer at block 4 (phase conv, second run): the DFT panel
    # padded to the tensor cores' 8, bc_grad_w's plain-DFT path
    "bc_fused@conv_k4": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                         "conv_bc_fused_k4", "conv_g2_k4_forward",
                         "conv_k4"),
    "bc_fused@conv_k4_adjoint": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
        "conv_bc_fused_k4", "conv_g2_k4_adjoint", "conv_k4"),
    "bc_grad_w@conv_k4": (
        bgw.KERNEL, "src/repro/core/circulant.py:247 (_bc_fft_bwd, XLA)",
        "conv_bc_grad_w_k4", "conv_g2_k4", "conv_k4"),
    # tinyllama-1.1b at block sizes 256 and 4 (phase block_sizes): up/gate
    # in the continuous engine's decode (B = 8) and at the training rows,
    # the weight gradient, the batch prefill's MAC at F = 129; counted at
    # the case's shape in that run (spectral_matmul: the lane's launches)
    **{f"bc_fused@k{k}": (bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
                          f"bc_fused_k{k}", f"k{k}_up_gate_b8",
                          f"block_sizes/k{k}/continuous")
       for k in BLOCK_SIZES},
    **{f"bc_fused@k{k}_train": (
        bc_fused.KERNEL, "src/repro/kernels/bc_fused.py:48",
        f"bc_fused_k{k}", f"k{k}_train_up_gate_b{BLOCK_ROWS}",
        f"block_sizes/k{k}/train") for k in BLOCK_SIZES},
    **{f"bc_grad_w@k{k}": (
        bgw.KERNEL, "src/repro/core/circulant.py:247 (_bc_fft_bwd, XLA)",
        f"bc_grad_w_k{k}", f"k{k}_up_gate_n{BLOCK_ROWS}",
        f"block_sizes/k{k}/train") for k in BLOCK_SIZES},
    "spectral_matmul@k256": (
        sm.KERNEL, "src/repro/kernels/spectral_matmul.py:42",
        "spectral_matmul_k256", f"k256_up_gate_n{ROWS}_hook",
        "block_sizes/k256/batch"),
    # the float8 dense cache (phase serve_kvf8): the one-row decode over
    # e4m3 K/V, counted on its plan path
    "flash_attention@e4m3_decode": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75", "flash_e4m3",
        f"e4m3_decode_b{KVF8['B']}_skv{KVF8['S'] + KVF8['new'] - 1}",
        "serve_kvf8"),
}


# the plan path (``Kernel.path_launches``) whose launches a new shape's
# line counts: the flash kernel its plan chose, bc_fused's expert stacks
SHAPE_PATHS = {"flash_attention@d96": "bf16", "bc_fused@expert": "single",
               "flash_attention@d96_decode": "f32_rows",
               "flash_attention@d96_prefill_f32": "f32_mma",
               "bc_fused@experts": "experts",
               "flash_attention@encoder": "bf16",
               "flash_attention@encoder_f32": "f32_mma",
               "flash_attention@cross_prefill": "f32_mma",
               "flash_attention@cross_decode": "f32_rows",
               "flash_attention@window_prefill": "bf16",
               "flash_attention@window_prefill_f32": "f32_mma",
               "flash_attention@ring_decode": "f32_rows",
               "bc_fused@whisper": "single", "bc_fused@xlstm": "single",
               "bc_fused@experts_e8": "experts",
               **{f"flash_attention@d256_{name}": path
                  for name, _, _, path in D256},
               "bc_fused@gemma2": "single",
               "bc_fused@recurrentgemma": "single",
               "bc_fused@experts_train": "experts",
               "bc_fused@experts_train_adjoint": "experts",
               "bc_grad_w@experts_mixtral": "experts",
               "bc_grad_w@experts_llama4": "experts",
               "flash_attention@e4m3_decode": "f32_rows_e4m3"}

T0 = time.perf_counter()
_LAST = [T0]                # when the previous phase line was printed


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    script started, and ``phase_wall_s``, the seconds since the previous
    phase line (a phase's own where it measures it)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {"phase_wall_s": now - _LAST[0], **obj, "t_s": now - T0}
        _LAST[0] = now
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


# samples of a graph timing: each is ``inner`` replays back to back
GRAPH_REPS = 5


def graph_ms(fn, inner: int = 10, reps: int = 15) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed and timed as ``time_ms`` times a call (at most
    ``GRAPH_REPS`` timings of ``inner`` replays back to back, the median
    divided by ``inner`` twice), so the host's work in the wrapper
    (checks, allocation, the ctypes call) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm: caches, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps=min(reps, GRAPH_REPS),
                   inner=inner) / inner


# timings of the millisecond-scale training cases: fewer calls, the same
# medians
LONG = dict(reps=5, inner=2)


def kernel_times(fn, reps: int = 15, inner: int = 10):
    """``kernel_ms``: a wrapper call back to back (host enqueue included,
    the time a caller sees); ``device_ms``: the same call replayed from a
    CUDA graph (the kernel alone).  A capture that fails leaves
    ``device_ms`` None with the reason."""
    out = {"kernel_ms": time_ms(fn, reps=reps, inner=inner)}
    try:
        out["device_ms"] = graph_ms(fn, inner=inner, reps=reps)
    except RuntimeError as e:               # measurement only
        torch.cuda.synchronize()
        out["device_ms"], out["device_ms_error"] = None, str(e)[:300]
    return out


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


def fused_work(B, p, q, k, lane="bc_fused", E=1):
    """(bytes, operations) of one ``bc_fused`` launch of B rows over p x q
    blocks (each of ``E`` experts of a stack) on ``lane``, as
    ``kernels/bc_fused.py:work`` counts them (the dry run's stand-in
    charges the same)."""
    w = bc_fused.work(E, B, p, q, k, lane)
    return w.nbytes, w.flops


def check_bc_fused(cfg, gen, shapes=None, batches=(8, 256),
                   lane_names=("bc_fused", "bc_fused_i8", "bc_fused_i4"),
                   timing=None):
    """The float32 lane and the int8 / int4 lanes, on the same weights and
    inputs at every projection, at B = 8 (decode slots) and 256 (prefill
    rows).  The quantized lanes get the same codes and scales as their plain
    version, so both sides contract identical values in float32.
    ``timing`` (``time_ms``'s reps and inner) for long calls."""
    timing = timing or {}
    k = cfg.compression.block_attn
    lanes = {lane: [] for lane in lane_names}
    for name, (n_in, n_out) in (shapes or projections(cfg)).items():
        w = cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                    device="cuda")
        planes = cc.spectral_cache(w)
        variants = {"bc_fused": ((planes["wr"], planes["ws1"],
                                  planes["ws2"]), None)}
        for bits, lane in ((8, "bc_fused_i8"), (4, "bc_fused_i4")):
            if lane not in lanes:
                continue
            qp = codec.quantize_plane_cache(planes, bits)
            variants[lane] = ((qp["wr"], qp["ws1"], qp["ws2"]),
                              [qp[n + "_s"] for n in ("wr", "ws1", "ws2")])
        p, q, _ = planes["wr"].shape
        w_t = cc.materialize_dense(w, n_out, n_in).T.contiguous()
        for B in batches:                    # decode slots, prefill rows
            xb = torch.randn((B, q, k), generator=gen, device="cuda")
            x2 = xb.reshape(B, q * k)[:, :n_in]
            library_ms = time_ms(lambda: x2 @ w_t, **timing)
            for lane, (pl, scales) in variants.items():
                got = bc_fused.bc_fused_matmul(xb, *pl, k, scales)
                ref = bc_fused.bc_fused_matmul_plain(xb, *pl, k, scales)
                torch.cuda.synchronize()
                err = max_err(got, ref)
                # float32 sums of a few hundred terms taken in another
                # order, over identical plane values: expected ~1e-6 of the
                # output's scale, held at 1e-4
                tol = 1e-4 * max(1.0, float(ref.abs().max()))
                nbytes, flops = fused_work(B, p, q, k, lane)
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                lanes[lane].append({
                    "case": f"{name}_b{B}", "shape": [B, p, q, k],
                    "launch_shape": bc_fused.shape_key(1, B, p, q, k, lane),
                    "plan": bc_fused.plan(B, p, q, k, lane)._asdict(),
                    "planes": str(pl[0].dtype).split(".")[-1],
                    "max_abs_err": err, "tol": tol,
                    **kernel_times(lambda: bc_fused.bc_fused_matmul(
                        xb, *pl, k, scales), **timing),
                    "plain_ms": time_ms(
                        lambda: bc_fused.bc_fused_matmul_plain(
                            xb, *pl, k, scales), **timing),
                    "library_ms": library_ms,
                    "library": "torch.matmul against the dense W (float32)",
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return {lane: (cases, "up_gate_b8") for lane, cases in lanes.items()}


def plain4(xb, planes, k, scales):
    """The 4-product lane's plain version, expert by expert for a stack."""
    if xb.dim() == 3:
        return bc_fused.bc_fused4_matmul_plain(xb, *planes, k, scales)
    return torch.stack([bc_fused.bc_fused4_matmul_plain(
        xb[e], *(w[e] for w in planes), k,
        None if scales is None else [s_[e] for s_ in scales])
        for e in range(xb.shape[0])])


def fused4_case(name, xb, planes, scales, k, library, library_name,
                timing=None, stack=False):
    """One case of the 4-product lane: the kernel against its plain
    version (expert by expert for a stack, whose experts must equal their
    single calls bit for bit), times, the dense library time and the
    bound."""
    timing = timing or {}
    lane = bc_fused.LANES4[planes[0].dtype]
    E = xb.shape[0] if stack else 1
    B, q, _ = xb.shape[-3:]
    p = planes[0].shape[-3]
    before = bc_fused.KERNEL.fn_launches[lane]
    got = bc_fused.bc_fused4_matmul(xb, *planes, k, scales)
    if bc_fused.KERNEL.fn_launches[lane] != before + 1:
        raise AssertionError(f"{lane} {name}: not one launch")
    ref = plain4(xb, planes, k, scales)
    torch.cuda.synchronize()
    equal = None
    if stack:
        equal = all(torch.equal(got[e], bc_fused.bc_fused4_matmul(
            xb[e], *(w[e] for w in planes), k,
            None if scales is None else [s_[e] for s_ in scales]))
            for e in range(E))
        if not equal:
            raise AssertionError(f"{lane} {name}: an expert differs from "
                                 f"its single call")
    err = max_err(got, ref)
    # float32 sums in another order over identical plane values, as the
    # Gauss lanes': ~1e-6 of the output's scale, held at 1e-4
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    nbytes, flops = fused_work(B, p, q, k, lane, E)
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return lane, {
        "case": name, "shape": [E, B, p, q, k],
        "launch_shape": bc_fused.shape_key(E, B, p, q, k, lane),
        "plan": bc_fused.plan(B, p, q, k, lane)._asdict(),
        "planes": str(planes[0].dtype).split(".")[-1],
        "max_abs_err": err, "tol": tol, "experts_bit_equal": equal,
        **kernel_times(lambda: bc_fused.bc_fused4_matmul(
            xb, *planes, k, scales), **timing),
        "plain_ms": time_ms(lambda: plain4(xb, planes, k, scales),
                            **timing),
        "library_ms": time_ms(library, **timing), "library": library_name,
        "bytes": nbytes, "flops": flops,
        "bound_ms": bound_ms, "bound_by": bound_by}


def check_bc_fused4(cfg, gen):
    """The 4-product lane (``gauss_trick=False``) against its plain
    version at tinyllama's up/gate: on its float32, int8 and int4 planes
    at B = 8 (the decode step's rows), on float32 planes at the training
    rows (2,048: ``NOGAUSS_TRAIN``'s), one expert stack (8 experts of 4
    rows, one launch), and the adjoint (the training backward's input
    gradient, planes wr^T, -wi^T) at the training rows.  Library: dense
    ``torch.matmul`` (``torch.bmm`` for the stack) against the
    materialized W in float32."""
    k = cfg.compression.block_ffn
    n_in, n_out = cfg.d_model, cfg.d_ff
    N = NOGAUSS_TRAIN["batch"] * NOGAUSS_TRAIN["seq"]
    w = cc.init_block_circulant(n_in, n_out, k, generator=gen, device="cuda")
    planes = cc.spectral_cache(w, gauss=False)
    p, q, _ = planes["wr"].shape
    dense = cc.materialize_dense(w, n_out, n_in).T.contiguous()
    lanes = {lane: [] for lane in bc_fused.LANES4.values()}
    for B in (8, N):
        xb = torch.randn((B, q, k), generator=gen, device="cuda")
        x2 = xb.reshape(B, q * k)[:, :n_in]
        timing = LONG if B > 8 else None
        variants = [(None, (planes["wr"], planes["wi"]), None)]
        if B == 8:
            for bits in (8, 4):
                qp = codec.quantize_plane_cache(planes, bits)
                variants.append((bits, (qp["wr"], qp["wi"]),
                                 [qp["wr_s"], qp["wi_s"]]))
        for _, pl, scales in variants:
            lane, case = fused4_case(f"up_gate_b{B}", xb, pl, scales, k,
                                     lambda: x2 @ dense,
                                     "torch.matmul against the dense W "
                                     "(float32)", timing)
            lanes[lane].append(case)
    # the adjoint at the training rows: gy (N, p, k) against W^H's planes
    adj = kops.adjoint_planes(planes)
    gy = torch.randn((N, p, k), generator=gen, device="cuda")
    g2 = gy.reshape(N, p * k)[:, :n_out]
    dense_t = dense.T.contiguous()
    lane, case = fused4_case(f"up_gate_adjoint_b{N}", gy,
                             (adj["wr"], adj["wi"]), None, k,
                             lambda: g2 @ dense_t,
                             "torch.matmul against the dense W^T (float32)",
                             LONG)
    lanes[lane].append(case)
    # one expert stack: 8 experts of 4 rows at up/gate's width
    E, C = 8, 4
    ws = torch.stack([cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                              device="cuda")
                      for _ in range(E)])
    sp = cc.spectral_cache(ws, gauss=False)
    xs = torch.randn((E, C, q, k), generator=gen, device="cuda")
    stack = torch.stack([cc.materialize_dense(ws[e], n_out, n_in).T
                         for e in range(E)]).contiguous()
    xs2 = xs.reshape(E, C, q * k)[..., :n_in]
    lane, case = fused4_case(f"stack_up_gate_e{E}_c{C}", xs,
                             (sp["wr"], sp["wi"]), None, k,
                             lambda: torch.bmm(xs2, stack),
                             "torch.bmm against the dense (E, n_in, n_out) "
                             "stack (float32)", stack=True)
    lanes[lane].append(case)
    del stack, dense, dense_t
    torch.cuda.empty_cache()
    return {lane: (cases, "up_gate_b8") for lane, cases in lanes.items()}


# The SDPA backend each dtype's library time is pinned to, in every run:
# flash for bf16; memory-efficient for float32 (flash takes no float32).
SDPA_PINNED = {torch.bfloat16: "FLASH_ATTENTION",
               torch.float32: "EFFICIENT_ATTENTION"}
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_library(q, k, v, pinned=None, **kw):
    """One ``F.scaled_dot_product_attention`` call on the same inputs as
    the yardstick: ``library_ms`` under the backend ``SDPA_PINNED`` names
    for the dtype (or ``pinned``), beside each backend's time (or why it
    refused) and the unpinned call's, which lets PyTorch choose.  GQA
    through ``enable_gqa`` where the backend takes it, else on K/V with
    their heads repeated beforehand (the repeat is not timed)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    sdpa = F.scaled_dot_product_attention
    reps = ((k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1))
            if G > 1 else (k, v))
    ways = (("enable_gqa", lambda: sdpa(q, k, v, enable_gqa=True, **kw)),
            ("repeated", lambda: sdpa(q, *reps, **kw)))
    backends = {}
    for name in SDPA_BACKENDS:
        why = None
        with sdpa_kernel([getattr(SDPBackend, name)]):
            for gqa, fn in ways:
                try:
                    fn()
                    torch.cuda.synchronize()
                except (RuntimeError, TypeError) as e:
                    why = str(e).splitlines()[0][:160]
                    continue
                backends[name] = {"ms": time_ms(fn), "gqa": gqa}
                break
        if name not in backends:
            backends[name] = {"refused": why}
    default = next(fn for gqa, fn in ways)
    pinned = pinned or SDPA_PINNED[q.dtype]
    if "ms" not in backends[pinned]:
        raise AssertionError(f"SDPA refused its pinned backend {pinned}: "
                             f"{backends[pinned]}")
    return {"library_ms": backends[pinned]["ms"],
            "library": "F.scaled_dot_product_attention("
                       + ", ".join(f"{a}={b}" for a, b in kw.items())
                       + f") under SDPBackend.{pinned}",
            "library_backend": pinned, "sdpa_backends": backends,
            "library_unpinned_ms": time_ms(default)}


def check_flash(cfg, gen, prefix="", s_bf16=256, s_f32=48):
    """The bf16 prefill lane at ``s_bf16`` positions (by default the
    longest prompt the serve phase's max_seq of 256 admits) and the float32
    lane at ``s_f32`` (the serve_parity prompt)."""
    a = cfg.attention
    Hq, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    cases = []
    for dtype, S in ((torch.bfloat16, s_bf16), (torch.float32, s_f32)):
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
        w = fa.work(1, Hq, Hkv, S, S, D, dtype, causal=True)
        nbytes, flops = w.nbytes, w.flops
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        cases.append({
            "case": f"{prefix}prefill_{str(dtype).split('.')[-1]}_s{S}",
            "shape": [1, Hq, Hkv, S, D],
            "plan": {**fa.plan(1, Hq, Hkv, S, S, D, dtype)._asdict(),
                     "dtype": str(dtype).split(".")[-1]},
            "max_abs_err": err, "tol": tol,
            **kernel_times(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v)),
            **sdpa_library(q, k, v, is_causal=True),
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
    return {"flash_attention": (cases, "prefill_bfloat16_s256")}


# the serve phase's positions (8 slots, tables of 16 pages): a partial
# last page (200, 17, 130, 95), page-aligned ends (63, 239), a slot inside
# its first page (5), and an idle slot (-1)
SERVE_POSITIONS = (200, 17, 63, -1, 130, 5, 239, 95)


def check_paged(cfg, gen, prefix="", maxp=16, positions=SERVE_POSITIONS,
                heads=None, pick=(0, 1, 2, 3), plain_timing=None):
    """The float lanes (bf16 and f32 queries on an f32 pool) and the int8
    lane (the same pool quantized per (page, head); f32 and bf16 queries)
    over one slot a position and tables of ``maxp`` pages of 16 (by
    default the serve phase's): at ``positions`` (the main cases), with
    the middle slot idle where no slot is (``_idle``), and with every slot
    at the table's last column (``_full``).  ``pick``: the variants (by
    index: bf16 / f32 query on the float pool, f32 / bf16 on the int8
    pool; ``prefix`` names the arch or shape); ``heads``: (Hq, Hkv, D) in
    place of ``cfg``'s; ``plain_timing``: ``time_ms``'s counts for the
    plain version."""
    Hq, Hkv, D = heads or (cfg.attention.num_heads,
                           cfg.attention.num_kv_heads, cfg.attention.head_dim)
    page, B = PAGE, len(positions)
    mixed = torch.tensor(positions, dtype=torch.int32, device="cuda")
    full = torch.full((B,), maxp * page - 1, dtype=torch.int32,
                      device="cuda")
    P = B * maxp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    mixed_table = table.clone()
    mixed_table[mixed < 0] = 0                # an idle slot owns no page
    runs = [("", mixed, mixed_table)]
    if not bool((mixed < 0).any()):
        idle, idle_table = mixed.clone(), table.clone()
        idle[B // 2], idle_table[B // 2] = -1, 0
        runs.append(("_idle", idle, idle_table))
    runs.append(("_full", full, table))
    pool_k = torch.randn((P, page, Hkv, D), generator=gen, device="cuda")
    pool_v = torch.randn((P, page, Hkv, D), generator=gen, device="cuda")
    k8, ks = codec.quantize_page_block(pool_k)
    v8, vs = codec.quantize_page_block(pool_v)
    lanes = {"paged_attention": [], "paged_attention_i8": []}
    variants = (("paged_attention", torch.bfloat16, pool_k, pool_v, {}),
                ("paged_attention", torch.float32, pool_k, pool_v, {}),
                ("paged_attention_i8", torch.float32, k8, v8,
                 {"k_scale": ks, "v_scale": vs}),
                ("paged_attention_i8", torch.bfloat16, k8, v8,
                 {"k_scale": ks, "v_scale": vs}))
    for lane, dtype, pk, pv, scales in [variants[i] for i in pick]:
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
        for suffix, positions, tab in runs:
            got = pa.paged_attention(q, pk, pv, tab, positions, **scales)
            ref = pa.paged_attention_stream(q, pk, pv, tab, positions,
                                            **scales)
            torch.cuda.synchronize()
            idle = positions < 0
            if not bool((got[idle] == 0).all()):
                raise AssertionError(f"{lane}: the idle slot is not "
                                     f"exactly 0")
            err = max_err(got, ref)
            if dtype == torch.bfloat16:
                # float32 in both, one rounding to bf16 each (see
                # check_flash)
                tol = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
            else:
                # identical codes and scales on both sides: float32 sums in
                # another order, held at 1e-4 of the output's scale
                tol = 1e-4 * max(1.0, float(ref.abs().max()))
            w = pa.work(B, Hq, Hkv, D, page, maxp, positions.tolist(),
                        dtype, pk.dtype)
            nbytes, flops = w.nbytes, w.flops
            bound_ms, bound_by = bound(nbytes, flops, torch.float32)
            pl = pa.plan(B, Hq, Hkv, D, page, maxp, pk.dtype)
            dt = str(dtype).split('.')[-1]
            lanes[lane].append({
                "case": prefix + (f"decode_int8_{dt}_b{B}" if scales
                                  else f"decode_{dt}_b{B}") + suffix,
                "shape": [B, Hq, Hkv, D, page, maxp],
                "pool": "int8" if scales else "float32",
                "plan": pl._asdict(),
                "positions": positions.tolist(), "max_abs_err": err,
                "tol": tol, "idle_slot_exact_zero": bool(idle.any()),
                **kernel_times(lambda: pa.paged_attention(
                    q, pk, pv, tab, positions, **scales)),
                "plain_ms": time_ms(lambda: pa.paged_attention_stream(
                    q, pk, pv, tab, positions, **scales),
                    **(plain_timing or {})),
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
        nbytes = pg.work(B, maxp, page * Hkv * D * pool.element_size()).nbytes
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


def check_flash_decode(cfg, gen, prefix="", B=8, Skv=231):
    """The batch engine's decode attention: ``B`` rows of one query each
    over a float32 dense cache of ``Skv`` positions (kv_offset Skv - 1);
    by default the longest the serve_batch phase reaches (8 rows, prompt
    200 + 31 decode steps).  The G query heads of a KV head share a block,
    the keys split over blocks and, below 8 packed rows a block, over the
    block's warps (the plan's ``key_groups``)."""
    a = cfg.attention
    Hq, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
    q = torch.randn((B, Hq, 1, D), generator=gen, device="cuda")
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda")
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda")
    off = Skv - 1
    got = fa.flash_attention(q, k, v, causal=True, kv_offset=off)
    ref = fa.attention_ref(q, k, v, causal=True, kv_offset=off)
    torch.cuda.synchronize()
    w = fa.work(B, Hq, Hkv, 1, Skv, D, torch.float32, causal=True,
                kv_offset=off)
    nbytes, flops = w.nbytes, w.flops
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
        **sdpa_library(q, k, v),
        "bytes": nbytes, "flops": flops,
        "bound_ms": bound_ms, "bound_by": bound_by}
    return {"flash_attention": ([case], None)}


def flex_library(q, k, v, got, *, causal, window, kv_offset, softcap):
    """The library time of a softcapped flash case: one call of
    ``torch.compile(flex_attention)`` with ``score_mod`` cap * tanh(s / cap),
    the case's causal and window mask as a block mask (built beforehand,
    not timed) and GQA through ``enable_gqa``.  ``library_err`` holds its
    output against the kernel's ``got``.  Where it does not compile or
    launch, ``library_ms`` is None and ``library`` says why."""
    import torch._dynamo
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    torch._dynamo.config.recompile_limit = max(
        64, torch._dynamo.config.recompile_limit)
    Sq, Skv = q.shape[2], k.shape[2]

    def mask_mod(b, h, qi, ki):
        r = qi + kv_offset
        m = ki >= 0
        if causal:
            m = m & (ki <= r)
        if window:
            m = m & (ki > r - window)
        return m

    def score_mod(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    masks = " & ".join(m for m, on in (("causal", causal),
                                        (f"window {window}", window)) if on)
    what = (f"torch.compile(flex_attention)(score_mod={softcap:g} * "
            f"tanh(s / {softcap:g}), block_mask={masks or None}, "
            "enable_gqa=True)")
    try:
        block_mask = (create_block_mask(mask_mod, None, None, Sq, Skv,
                                        device="cuda")
                      if causal or window else None)
        fn = torch.compile(flex_attention, dynamic=False)
        call = lambda: fn(q, k, v, score_mod=score_mod,  # noqa: E731
                          block_mask=block_mask, enable_gqa=True)
        err = max_err(call(), got)
        torch.cuda.synchronize()
        return {"library_ms": time_ms(call, reps=5, inner=2, warmup=1),
                "library": what, "library_err": err}
    except Exception as e:                  # the yardstick only
        torch.cuda.synchronize()
        return {"library_ms": None,
                "library": f"none: {what} failed: "
                           + (str(e).strip().splitlines() or [repr(e)])[0][:200]}


def check_attention(name, B, Hq, Hkv, Sq, Skv, D, dtype, gen, *,
                    causal=False, window=0, kv_offset=0, softcap=0.0,
                    sdpa_pinned=None, ref_rows=False, q_scale=1.0,
                    library=True):
    """One flash case at a shape the batch-only archs bring: random
    q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D) in ``dtype``, the kernel
    against ``attention_ref`` (tolerance as ``check_flash``), its bound
    from the (row, key) pairs the mask keeps, and SDPA on the same inputs
    (a window goes to SDPA as a boolean mask, which its flash backend does
    not take: such a case pins ``sdpa_pinned``; a logit ``softcap``, which
    no SDPA call computes, takes ``flex_library`` instead).  With
    ``ref_rows`` the plain version runs one batch row at a time (its (Hq, Sq, Skv) float32
    scores for all B rows at once would not fit beside the rest): the
    error is the largest row's, ``plain_ms`` the time of the B calls.
    With a ``softcap``, ``uncapped_err`` is the kernel's error when
    launched without it (how far the case tells the cap's absence).
    ``q_scale`` multiplies q, so that scores reach a softcap; a case
    without ``library`` checks the kernel only and times no library
    call."""
    q = (q_scale * torch.randn((B, Hq, Sq, D), generator=gen,
                               device="cuda")).to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset,
              softcap=softcap)
    parts = ([slice(b, b + 1) for b in range(B)] if ref_rows
             else [slice(None)])
    plain = lambda: [fa.attention_ref(q[r], k[r], v[r], **kw)  # noqa: E731
                     for r in parts]
    got = fa.flash_attention(q, k, v, **kw)
    refs = plain()
    torch.cuda.synchronize()
    scale = max(1.0, *(float(ref.float().abs().max()) for ref in refs))
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    err = max(max_err(got[r], ref) for r, ref in zip(parts, refs))
    uncapped = {}
    if softcap:                 # how far a kernel that dropped the cap is
        bare = fa.flash_attention(q, k, v, **{**kw, "softcap": 0.0})
        uncapped["uncapped_err"] = max(max_err(bare[r], ref)
                                       for r, ref in zip(parts, refs))
        del bare
    del refs
    rows = torch.arange(Sq)[:, None] + kv_offset
    cols = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    pairs = fa.pairs(Sq, Skv, causal=causal, window=window,
                     kv_offset=kv_offset)
    w = fa.work(B, Hq, Hkv, Sq, Skv, D, dtype, causal=causal, window=window,
                kv_offset=kv_offset)
    nbytes, flops = w.nbytes, w.flops
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    if window or (causal and (kv_offset or Sq != Skv)):
        lib_kw = {"attn_mask": mask.to("cuda")}
    else:
        lib_kw = {"is_causal": True} if causal else {}
    if not library:
        library = {"library_ms": None, "library": "not timed"}
    elif softcap:
        library = flex_library(q, k, v, got, **kw)
    else:
        library = sdpa_library(q, k, v, pinned=sdpa_pinned, **lib_kw)
    return {
        "case": name, "shape": [B, Hq, Hkv, Sq, Skv, D],
        "launch_shape": fa.shape_key(B, Hq, Hkv, Sq, Skv, D, dtype,
                                     causal=causal, window=window,
                                     kv_offset=kv_offset),
        "causal": causal, "window": window, "kv_offset": kv_offset,
        "softcap": softcap, "q_scale": q_scale, **uncapped, "pairs": pairs,
        "ref_rows": ref_rows,
        "plan": {**fa.plan(B, Hq, Hkv, Sq, Skv, D, dtype)._asdict(),
                 "dtype": str(dtype).split(".")[-1]},
        "max_abs_err": err, "tol": tol,
        **kernel_times(lambda: fa.flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(plain, reps=5, inner=2, warmup=1),
        **library, "bytes": nbytes, "flops": flops,
        "bound_ms": bound_ms, "bound_by": bound_by}


def check_head_dim_256(gen):
    """The flash kernel at head dim 256, at the shapes serve_gemma2 and
    serve_recurrentgemma give it.  gemma2 (16/8 heads, softcap 50, layers
    alternating a window of 4,096 and global): the batch run's prefills
    (bf16, 4 prompts padded to 4,200; the plain version a row at a time)
    on both kinds of layer, the float32 oracle's (1 x 4,100), and the
    batch run's last decode step (4 rows) over the global layers' linear
    cache and over the local layers' ring.  recurrentgemma (10/1 heads:
    G = 10; window 2,048, no softcap): the batch run's prefill (4 x
    2,150), the oracle's (1 x 2,100) and the last ring decode step.  Every
    kernel lane at D = 256; SDPA for recurrentgemma's (a window: the
    memory-efficient backend), compiled ``flex_attention`` for gemma2's
    (the softcap).  Scores of unit variance barely reach a cap of 50, so
    each lane also runs a cap of 4 on q scaled by 8 (``_cap4``; no
    library time), which fail unless the kernel launched uncapped misses
    its tolerance more than tenfold."""
    f32, bf16 = torch.float32, torch.bfloat16
    ga, ra = get_config(GEMMA2).attention, get_config(RGEMMA).attention
    g, r = (ga.num_heads, ga.num_kv_heads), (ra.num_heads, ra.num_kv_heads)
    gw, rw, cap, D = (ga.sliding_window, ra.sliding_window, ga.logit_softcap,
                      ga.head_dim)
    ghi, golen = BATCH_ARCH[GEMMA2]["hi"], BATCH_ARCH[GEMMA2]["oracle_len"]
    rhi, rolen = BATCH_ARCH[RGEMMA]["hi"], BATCH_ARCH[RGEMMA]["oracle_len"]
    eff = dict(sdpa_pinned="EFFICIENT_ATTENTION")
    cases = [
        check_attention(f"gemma2_prefill_bfloat16_b4_s{ghi}_w{gw}", 4, *g,
                        ghi, ghi, D, bf16, gen, causal=True, window=gw,
                        softcap=cap, ref_rows=True),
        check_attention(f"gemma2_prefill_bfloat16_b4_s{ghi}", 4, *g, ghi,
                        ghi, D, bf16, gen, causal=True, softcap=cap,
                        ref_rows=True),
        check_attention(f"gemma2_prefill_float32_s{golen}_w{gw}", 1, *g,
                        golen, golen, D, f32, gen, causal=True, window=gw,
                        softcap=cap),
        check_attention(f"gemma2_prefill_float32_s{golen}", 1, *g, golen,
                        golen, D, f32, gen, causal=True, softcap=cap),
        check_attention(f"gemma2_decode_float32_b4_skv{GLOBAL_KEYS}", 4, *g,
                        1, GLOBAL_KEYS, D, f32, gen, causal=True,
                        kv_offset=GLOBAL_KEYS - 1, softcap=cap),
        check_attention(
            f"gemma2_ring_decode_float32_b4_skv{RING_KEYS[GEMMA2]}", 4, *g,
            1, RING_KEYS[GEMMA2], D, f32, gen, softcap=cap),
        check_attention(f"recurrentgemma_prefill_bfloat16_b4_s{rhi}_w{rw}",
                        4, *r, rhi, rhi, D, bf16, gen, causal=True,
                        window=rw, ref_rows=True, **eff),
        check_attention(f"recurrentgemma_prefill_float32_s{rolen}_w{rw}", 1,
                        *r, rolen, rolen, D, f32, gen, causal=True,
                        window=rw),
        check_attention(
            f"recurrentgemma_ring_decode_float32_b4_skv{RING_KEYS[RGEMMA]}",
            4, *r, 1, RING_KEYS[RGEMMA], D, f32, gen)]
    bite = dict(softcap=4.0, q_scale=8.0, library=False)
    cases += [
        check_attention("gemma2_prefill_bfloat16_s1024_w512_cap4", 1, *g,
                        1024, 1024, D, bf16, gen, causal=True, window=512,
                        **bite),
        check_attention("gemma2_prefill_float32_s512_cap4", 1, *g, 512, 512,
                        D, f32, gen, causal=True, **bite),
        check_attention("gemma2_decode_float32_b4_skv1500_cap4", 4, *g, 1,
                        1500, D, f32, gen, causal=True, kv_offset=1499,
                        **bite)]
    blind = [c["case"] for c in cases[-3:]
             if not c["uncapped_err"] > 10 * c["tol"]]
    if blind:
        raise AssertionError(f"a cap of 4 does not bite in {blind}")
    from torch._inductor.async_compile import shutdown_compile_workers
    shutdown_compile_workers()              # flex_library's compile pool
    return {"flash_attention": (cases, None)}


def check_new_flash(gen):
    """The flash lanes the padded tiles opened: bf16 at D = 32 at the
    shape serve_smoke's tinyllama batch prefill gives it and at B = 4 x
    S = 2,048 with 32 / 32 heads; bf16 at phi-2's 32 heads of 80 (the 96
    tile); float32 at D = 192 on the tensor-core prefill (S = 2,048, the
    256 tile) and the rows kernel (one row over 4,096 keys)."""
    f32, bf16 = torch.float32, torch.bfloat16
    n = NEW_LANES
    ta = get_smoke_config(ARCH).attention
    B, S = len(_SMOKE_REQS), _SMOKE_S
    return {"flash_attention": ([
        check_attention(f"smoke_prefill_bfloat16_b{B}_s{S}_d32", B,
                        ta.num_heads, ta.num_kv_heads, S, S, ta.head_dim,
                        bf16, gen, causal=True),
        check_attention(f"prefill_bfloat16_b{n['b32']}_s{n['s']}_d32",
                        n["b32"], n["h32"], n["h32"], n["s"], n["s"], 32,
                        bf16, gen, causal=True),
        check_attention(f"phi2_prefill_bfloat16_s{n['s']}_d80", 1,
                        *n["phi2"][:2], n["s"], n["s"], n["phi2"][2], bf16,
                        gen, causal=True),
        check_attention(f"prefill_float32_s{n['s']}_d192", 1,
                        *n["d192"][:2], n["s"], n["s"], n["d192"][2], f32,
                        gen, causal=True),
        check_attention(f"decode_float32_skv{n['skv']}_d192", 1,
                        *n["d192"][:2], 1, n["skv"], n["d192"][2], f32, gen,
                        causal=True, kv_offset=n["skv"] - 1)], None)}


def check_batch_archs_attention(gen):
    """The flash kernel at the shapes serve_mixtral and serve_whisper give
    it: whisper's bidirectional encoder (bf16 as the batch run serves it,
    4 requests of 1,500 frames, 20/20 heads of 64; float32 as the B=1
    oracle runs it), its cross-attention over the 1,500 cached keys (the
    batch run's prefill of 4 x 200 rows and one-row decode, float32: the
    query is cast to the float32 cache), mixtral's windowed prefill
    (window 4,096, 32/8 heads of 128: bf16 at the batch run's 4 prompts
    padded to 4,200, float32 at the oracle's 1 x 4,100) and its ring decode
    (the batch run's 4 rows at its last decode step, non-causal)."""
    f32, bf16 = torch.float32, torch.bfloat16
    wa, ma = get_config(WHISPER).attention, get_config(MIXTRAL).attention
    w = (wa.num_heads, wa.num_kv_heads)
    m = (ma.num_heads, ma.num_kv_heads)
    W = ma.sliding_window
    mix = BATCH_ARCH[MIXTRAL]
    hi, olen = mix["hi"], mix["oracle_len"]
    cases = [
        check_attention("whisper_encoder_bfloat16_b4_s1500", 4, *w, 1500,
                        1500, wa.head_dim, bf16, gen),
        check_attention("whisper_encoder_float32_b1_s1500", 1, *w, 1500,
                        1500, wa.head_dim, f32, gen),
        check_attention("whisper_cross_prefill_float32_b4_s200_skv1500", 4,
                        *w, 200, 1500, wa.head_dim, f32, gen),
        check_attention("whisper_cross_decode_float32_b4_skv1500", 4, *w, 1,
                        1500, wa.head_dim, f32, gen),
        check_attention(f"mixtral_prefill_bfloat16_b4_s{hi}_w{W}", 4, *m,
                        hi, hi, ma.head_dim, bf16, gen, causal=True,
                        window=W, sdpa_pinned="EFFICIENT_ATTENTION",
                        ref_rows=True),
        check_attention(f"mixtral_prefill_float32_s{olen}_w{W}", 1, *m,
                        olen, olen, ma.head_dim, f32, gen, causal=True,
                        window=W),
        check_attention(
            f"mixtral_ring_decode_float32_b4_skv{RING_KEYS[MIXTRAL]}", 4, *m,
            1, RING_KEYS[MIXTRAL], ma.head_dim, f32, gen)]
    return {"flash_attention": (cases, None)}


def gemma_projections():
    """(name -> (n_in, n_out)) of gemma2's and recurrentgemma's distinct
    projections (the RG-LRU's in_x, in_gate, gate_r, gate_i and out share
    recurrentgemma's q_o shape)."""
    return {f"{arch.split('-')[0]}_{name}": io for arch in (GEMMA2, RGEMMA)
            for name, io in projections(get_config(arch)).items()}


def batch_arch_projections():
    """(name -> (n_in, n_out)) of whisper's and xlstm's decode projections
    (the batch engine's B = 4 rows), and whisper's for the encoder's
    spectral MAC."""
    wc, xc = get_config(WHISPER), get_config(XLSTM)
    d, dff = wc.d_model, wc.d_ff
    whisper = {"whisper_q_o": (d, d), "whisper_up": (d, dff),
               "whisper_down": (dff, d)}
    xd = xc.d_model
    xi = int(xd * xc.recurrent.proj_factor)
    xlstm = {"xlstm_up": (xd, xi), "xlstm_qkv": (xi, xi),
             "xlstm_out": (xi, xd), "xlstm_wx": (xd, 4 * xd),
             "xlstm_slstm_out": (xd, xd)}
    return whisper, xlstm


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


def hook_views(xr, xi, wr, ws1, ws2):
    """The same values as ``kops.spectral_contract`` passes them: (F, N, Q)
    views of (N, Q, F) spectra and (F, Q, P) views of (P, Q, F) planes
    (``spectral_matmul``'s bin-minor layout)."""
    xs = [t.permute(1, 2, 0).contiguous().permute(2, 0, 1) for t in (xr, xi)]
    ws = [t.permute(2, 1, 0).contiguous().permute(2, 1, 0)
          for t in (wr, ws1, ws2)]
    return (*xs, *ws)


def replay_equal(fn, want) -> bool:
    """One call of ``fn`` captured in a CUDA graph and replayed: do its
    outputs equal ``want`` bit for bit?"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(o, w) for o, w in zip(out, want))


def fused_projections(cfg):
    """tinyllama-1.1b's fused projections: q/k/v as one (p = 16 + 2 + 2)
    and up/gate as one (p = 44 + 44)."""
    a = cfg.attention
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    return {"tinyllama_fused_qkv": (cfg.d_model, hq + 2 * hkv),
            "tinyllama_fused_up_gate": (cfg.d_model, 2 * cfg.d_ff)}


def check_spectral(cfg, gen, shapes=None, N=ROWS, timing=None):
    """``spectral_matmul`` against its plain version at every batch-prefill
    shape (F = 65, N = 2048 rows), in both layouts: ``repro``'s contiguous
    one (``<name>_n2048``) and the views ``spectral_contract`` passes
    (``<name>_n2048_hook``).  Each case is called twice (the same bits) and
    replayed from a CUDA graph (the eager call's bits); the library time
    is one complex64 ``torch.matmul`` computing the same product; a hook
    case also times ``copies_ms``, the layout copies of its operands that
    ``spectral_contract`` made on every call before it read views.  ``N``
    rows (default tinyllama's 2048).  The tolerance: 3xTF32 sums Q terms
    in another order than ``torch.bmm``, ~1e-6 of the output scale; 1e-4
    of it is allowed.  ``timing`` (``time_ms``'s reps and inner) for
    long calls."""
    timing = timing or {}
    cases = []
    for name, n_in, n_out, k in shapes or spectral_shapes():
        F_ = k // 2 + 1
        Q, P = cc.num_blocks(n_in, k), cc.num_blocks(n_out, k)
        xr, xi = (torch.randn((F_, N, Q), generator=gen, device="cuda")
                  for _ in range(2))
        wr, ws1, ws2 = (torch.randn((F_, Q, P), generator=gen,
                                    device="cuda") * Q ** -0.5
                        for _ in range(3))
        xc, wc = torch.complex(xr, xi), torch.complex(wr, ws1 + wr)
        library_ms = time_ms(lambda: torch.matmul(xc, wc), **timing)
        del xc, wc
        w = sm.work(F_, N, Q, P)
        nbytes, flops = w.nbytes, w.flops
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        major = (xr, xi, wr, ws1, ws2)
        for suffix, planes in (("", major), ("_hook", hook_views(*major))):
            call = lambda: sm.spectral_matmul(*planes)  # noqa: E731
            got = call()
            again = call()
            ref = sm.spectral_matmul_plain(*planes)
            torch.cuda.synchronize()
            repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            graph_equal = replay_equal(call, got)
            if not (repeat_equal and graph_equal):
                raise AssertionError(f"spectral_matmul {name}{suffix}: "
                                     f"repeat {repeat_equal}, graph replay "
                                     f"{graph_equal}")
            err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
            tol = 1e-4 * max(1.0, float(ref[0].abs().max()),
                             float(ref[1].abs().max()))
            layout = sm.layout_of(*planes)
            pl = sm.plan(F_, N, Q, P, layout)
            # the hook's layout copies the parent tree made on every call
            copies = ({"copies_ms": graph_ms(
                lambda: [t.contiguous() for t in planes])} if suffix else {})
            cases.append({
                "case": f"{name}_n{N}{suffix}", "shape": [F_, N, Q, P],
                "launch_shape": sm.shape_key(F_, N, Q, P, layout),
                "layout": sm.LAYOUT_NAMES[layout],
                "plan": {**pl._asdict(), "grid": pl.grid, "block": pl.block,
                         "rows": pl.rows, "p_tile": pl.p_tile},
                "max_abs_err": err, "tol": tol,
                "repeat_equal": repeat_equal, "graph_equal": graph_equal,
                **kernel_times(call, **timing),
                "plain_ms": time_ms(lambda: sm.spectral_matmul_plain(
                    *planes), **timing),
                "library_ms": library_ms,
                "library": "torch.matmul on complex64 (F, N, Q) @ (F, Q, P)",
                **copies, "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms, "bound_by": bound_by})
            del got, again, ref
    return {"spectral_matmul": (cases, "tinyllama_q_o_n2048")}


# ---------------------------------------------------------------------------
# training: bc_grad_w and bc_fused at the training shapes, then the trainer
# ---------------------------------------------------------------------------
def train_projections(cfg):
    """name -> (n_in, n_out) of each of a layer's seven projections."""
    a = cfg.attention
    d, dff = cfg.d_model, cfg.d_ff
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    return {"q": (d, hq), "k": (d, hkv), "v": (d, hkv), "o": (hq, d),
            "up": (d, dff), "gate": (d, dff), "down": (dff, d)}


def train_shape_counts(cfg, N):
    """The launches one training step makes, by shape, derived from the
    model: every projection's forward (twice under remat: the backward
    runs each layer's forward again) and its adjoint (the input gradient:
    the fused kernel at (p, q) swapped) through ``bc_fused``, and its
    weight gradient through ``bc_grad_w``, once a layer."""
    k = cfg.compression.block_attn
    fwd = 2 if cfg.remat == "full" else 1
    fused, grads = {}, {}
    for n_in, n_out in train_projections(cfg).values():
        p, q = cc.num_blocks(n_out, k), cc.num_blocks(n_in, k)
        for key, n in ((bc_fused.shape_key(1, N, p, q, k, "bc_fused"), fwd),
                       (bc_fused.shape_key(1, N, q, p, k, "bc_fused"), 1)):
            fused[key] = fused.get(key, 0) + n * cfg.num_layers
        key = bgw.shape_key(N, p, q, k)
        grads[key] = grads.get(key, 0) + cfg.num_layers
    return fused, grads


def train_kernel_shapes(cfg):
    """bc_fused at the training rows: each distinct (p, q) of the forward
    and the adjoint (the adjoint of up/gate is down's shape, of down
    up/gate's, of q/o q/o's; k/v's is its own)."""
    a = cfg.attention
    d, dff = cfg.d_model, cfg.d_ff
    hkv = a.num_kv_heads * a.head_dim
    return {"train_q_o": (d, a.num_heads * a.head_dim),
            "train_k_v": (d, hkv), "train_k_v_adjoint": (hkv, d),
            "train_up_gate": (d, dff), "train_down": (dff, d)}


def grad_w_work(E, C, p, q, k):
    """(bytes, operations) of ``bc_grad_w`` over E experts of C rows (E =
    1: one projection), as ``kernels/bc_grad_w.py:work`` counts them."""
    w = bgw.work(C, p, q, k, E)
    return w.nbytes, w.flops


def check_bc_grad_w(cfg, gen, N=TRAIN_ROWS, shapes=None):
    """``bc_grad_w`` at every training shape of tinyllama-1.1b (N = 8 x
    1,024 rows; the fused q/k/v and up/gate too) against its plain version
    on the same inputs, and a second call bit-equal to the first; each
    case carries the plan it took.  The library time is one complex64
    ``torch.bmm`` over the bins (p x N by N x q per bin): the contraction
    alone, without the two DFTs and the iDFT.  ``library_whole_ms`` is the
    whole function as three library calls in sequence (``torch.fft.rfft``
    of both inputs, that ``torch.bmm``, ``torch.fft.irfft``), its error
    against the plain version beside it.  ``shapes`` (name -> (n_in,
    n_out)) replaces those; the first is the main case."""
    k = cfg.compression.block_attn
    main = f"tinyllama_up_gate_n{N}"
    if shapes is None:
        shapes = {f"tinyllama_{name}": io
                  for name, io in projections(cfg).items()}
        shapes.update(fused_projections(cfg))
    else:
        main = f"{next(iter(shapes))}_n{N}"
    cases = []
    for name, (n_in, n_out) in shapes.items():
        p, q = cc.num_blocks(n_out, k), cc.num_blocks(n_in, k)
        gy = torch.randn((N, p, k), generator=gen, device="cuda")
        xb = torch.randn((N, q, k), generator=gen, device="cuda")
        got = bgw.bc_grad_w(gy, xb, k)
        again = bgw.bc_grad_w(gy, xb, k)
        ref = bgw.bc_grad_w_plain(gy, xb, k)
        torch.cuda.synchronize()
        # float32 sums over N rows in another order: measured <= 4.5e-6 of
        # the output's scale, held at 1e-4
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        gr, gi = cc.rfft_planes(gy, k)
        xr, xi = cc.rfft_planes(xb, k)
        gc = torch.complex(gr, gi).permute(2, 1, 0).contiguous()
        xc = torch.complex(xr, -xi).permute(2, 0, 1).contiguous()

        def whole():
            gf = torch.fft.rfft(gy, dim=-1).permute(2, 1, 0)
            xf = torch.fft.rfft(xb, dim=-1).conj().permute(2, 0, 1)
            return torch.fft.irfft(torch.bmm(gf, xf).permute(1, 2, 0),
                                   n=k, dim=-1)
        whole_err = max_err(whole(), ref)
        nbytes, flops = grad_w_work(1, N, p, q, k)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        cases.append({
            "case": f"{name}_n{N}", "shape": [N, p, q, k],
            "launch_shape": bgw.shape_key(N, p, q, k),
            "plan": bgw.plan(N, p, q, k)._asdict(),
            "max_abs_err": max_err(got, ref), "tol": tol,
            "bit_equal": bool(torch.equal(got, again)),
            **kernel_times(lambda: bgw.bc_grad_w(gy, xb, k), **LONG),
            "plain_ms": time_ms(lambda: bgw.bc_grad_w_plain(gy, xb, k),
                                **LONG),
            "library_ms": time_ms(lambda: torch.bmm(gc, xc), **LONG),
            "library": "torch.bmm, complex64, the contraction over the "
                       "rows alone (no DFT, no iDFT)",
            "library_whole_ms": time_ms(whole, **LONG),
            "library_whole": "three library calls: torch.fft.rfft of gy "
                             "and xb, complex64 torch.bmm, torch.fft.irfft",
            "library_whole_err": whole_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
        if not cases[-1]["bit_equal"]:
            raise AssertionError(f"bc_grad_w {name}: two calls differ")
    return {"bc_grad_w": (cases, main)}


def moe_capacity(cfg, T):
    """(G, cap) of a train step's MoE over T tokens (``layers/ffn.py:moe``):
    G routing groups of g = gcd(min(router_group_size, T), T) tokens, each
    expert's buffer ``cap`` rows a group."""
    m = cfg.moe
    g = math.gcd(min(m.router_group_size, T), T)
    cap = max(1, int(math.ceil(g * m.top_k / m.num_experts
                               * m.capacity_factor)))
    return T // g, min(cap, g)


def train_stack_shapes():
    """(E, C, p, q, k) of the expert projections the MoE train phases
    launch, by name: up/gate and down of mixtral (2 x 4,608 tokens: G =
    18, cap = 160, C = 2,880) and llama4 (8 x 1,024: cap = 5, C = 80)."""
    out = {}
    for arch, fam in ((MIXTRAL, "mixtral"), (MOE, "llama4")):
        cfg, t = get_config(arch), TRAIN_ARCHS[arch]
        G, cap = moe_capacity(cfg, t["batch"] * t["seq"])
        k = cfg.compression.block_for("expert")
        p, q = cc.num_blocks(cfg.d_ff, k), cc.num_blocks(cfg.d_model, k)
        E = cfg.moe.num_experts
        out[f"{fam}_up_gate"] = (E, G * cap, p, q, k)
        out[f"{fam}_down"] = (E, G * cap, q, p, k)
    return out


def check_train_stacks(gen):
    """The expert-stack lanes at the MoE train phases' shapes
    (``train_stack_shapes``): ``bc_grad_w`` over the stack (one call) and
    ``bc_fused``'s stack forward and adjoint (one launch each), each
    against its plain version expert by expert (float32 sums in another
    order: 1e-4 of the output's scale), and every expert equal bit for
    bit to the single call on its rows.  Library times: for bc_grad_w one
    complex64 ``torch.bmm`` over E x kf bins (the contraction alone) and
    the whole function as three calls (``torch.fft.rfft``, that
    ``torch.bmm``, ``torch.fft.irfft``); for bc_fused one ``torch.bmm``
    against the dense (E, n_in, n_out) float32 stack, built and freed
    here."""
    grad_cases, fused_cases = [], []
    for name, (E, C, p, q, k) in train_stack_shapes().items():
        kf = k // 2 + 1
        gy = torch.randn((E, C, p, k), generator=gen, device="cuda")
        xb = torch.randn((E, C, q, k), generator=gen, device="cuda")
        before = bgw.KERNEL.path_launches.get("experts", 0)
        got = bgw.bc_grad_w(gy, xb, k)
        if bgw.KERNEL.path_launches["experts"] != before + 1:
            raise AssertionError(f"bc_grad_w {name}: not one call")
        equal = all(torch.equal(got[e], bgw.bc_grad_w(gy[e], xb[e], k))
                    for e in range(E))
        ref = torch.stack([bgw.bc_grad_w_plain(gy[e], xb[e], k)
                           for e in range(E)])
        torch.cuda.synchronize()
        gr, gi = cc.rfft_planes(gy, k)
        xr, xi = cc.rfft_planes(xb, k)
        gc = torch.complex(gr, gi).permute(0, 3, 2, 1).reshape(
            E * kf, p, C).contiguous()
        xc = torch.complex(xr, -xi).permute(0, 3, 1, 2).reshape(
            E * kf, C, q).contiguous()
        del gr, gi, xr, xi

        def whole():
            gf = torch.fft.rfft(gy, dim=-1).permute(0, 3, 2, 1).reshape(
                E * kf, p, C)
            xf = torch.fft.rfft(xb, dim=-1).conj().permute(0, 3, 1, 2) \
                .reshape(E * kf, C, q)
            u = torch.bmm(gf, xf).reshape(E, kf, p, q).permute(0, 2, 3, 1)
            return torch.fft.irfft(u, n=k, dim=-1)
        nbytes, flops = grad_w_work(E, C, p, q, k)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        pl = bgw.plan(C, p, q, k)
        grad_cases.append({
            "case": f"{name}_e{E}_c{C}", "shape": [E, C, p, q, k],
            "launch_shape": bgw.shape_key(C, p, q, k, E),
            "plan": pl._asdict(), "group": bgw.stack_group(E, pl),
            "max_abs_err": max_err(got, ref),
            "tol": 1e-4 * max(1.0, float(ref.abs().max())),
            "expert_equal": equal,
            **kernel_times(lambda: bgw.bc_grad_w(gy, xb, k), **LONG),
            "plain_ms": time_ms(lambda: torch.stack([
                bgw.bc_grad_w_plain(gy[e], xb[e], k) for e in range(E)]),
                reps=3, inner=1, warmup=1),
            "plain": "bc_grad_w_plain expert by expert",
            "library_ms": time_ms(lambda: torch.bmm(gc, xc), **LONG),
            "library": "torch.bmm, complex64, over E x kf bins: the "
                       "contraction alone (no DFT, no iDFT)",
            "library_whole_ms": time_ms(whole, **LONG),
            "library_whole": "torch.fft.rfft of gy and xb, complex64 "
                             "torch.bmm, torch.fft.irfft",
            "library_whole_err": max_err(whole(), ref),
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
        del gc, xc, got, ref
        if not equal:
            raise AssertionError(f"bc_grad_w {name}: an expert differs from "
                                 f"the single call")
        if name.endswith("_up_gate"):        # bc_fused: forward, adjoint
            n_in, n_out = q * k, p * k
            w = torch.randn((E, p, q, k), generator=gen,
                            device="cuda") / math.sqrt(n_in)
            planes = cc.spectral_cache(w)
            adj = kops.adjoint_planes(planes)
            dense = torch.empty((E, n_in, n_out), device="cuda")
            for e in range(E):
                dense[e] = cc.materialize_dense(w[e], n_out, n_in).T
            x2, g2 = xb.reshape(E, C, n_in), gy.reshape(E, C, n_out)
            for tag, pl_, x, lib in (
                    ("", planes, xb, lambda: torch.bmm(x2, dense)),
                    ("_adjoint", adj, gy,
                     lambda: torch.bmm(g2, dense.transpose(1, 2)))):
                args = (pl_["wr"], pl_["ws1"], pl_["ws2"], k)
                pp, qq = pl_["wr"].shape[1:3]
                before = bc_fused.KERNEL.path_launches.get("experts", 0)
                got = bc_fused.bc_fused_matmul(x, *args)
                if bc_fused.KERNEL.path_launches["experts"] != before + 1:
                    raise AssertionError(f"bc_fused {name}{tag}: not one "
                                         f"launch")
                equal = all(torch.equal(got[e], bc_fused.bc_fused_matmul(
                    x[e], *(t[e] for t in args[:3]), k)) for e in range(E))
                ref = torch.stack([bc_fused.bc_fused_matmul_plain(
                    x[e], *(t[e] for t in args[:3]), k) for e in range(E)])
                torch.cuda.synchronize()
                nbytes, flops = fused_work(C, pp, qq, k, E=E)
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                fused_cases.append({
                    "case": f"train_{name}{tag}_e{E}_c{C}",
                    "shape": [E, C, pp, qq, k],
                    "launch_shape": bc_fused.shape_key(E, C, pp, qq, k,
                                                       "bc_fused"),
                    "launch_args": list(bc_fused.launch_args(
                        C, pp, qq, k, "bc_fused", E)),
                    "max_abs_err": max_err(got, ref),
                    "tol": 1e-4 * max(1.0, float(ref.abs().max())),
                    "expert_equal": equal,
                    **kernel_times(lambda: bc_fused.bc_fused_matmul(
                        x, *args), **LONG),
                    "plain_ms": time_ms(lambda: torch.stack([
                        bc_fused.bc_fused_matmul_plain(
                            x[e], *(t[e] for t in args[:3]), k)
                        for e in range(E)]), reps=3, inner=1, warmup=1),
                    "plain": "bc_fused_matmul_plain expert by expert",
                    "library_ms": time_ms(lib, **LONG),
                    "library": "torch.bmm against the dense (E, n_in, "
                               "n_out) float32 stack",
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": bound_ms, "bound_by": bound_by})
                del got, ref
                if not equal:
                    raise AssertionError(f"bc_fused {name}{tag}: an expert "
                                         f"differs from the single call")
            del dense, w, planes, adj
        del gy, xb
        torch.cuda.empty_cache()
    return {"bc_grad_w": (grad_cases, "mixtral_up_gate_e8_c2880"),
            "bc_fused": (fused_cases, "train_mixtral_up_gate_e8_c2880")}


def train_steps_summary(history, first=2):
    """ms per step: the median over the steps from ``first`` (0-based)."""
    ms = [1e3 * h["step_s"] for h in history]
    return ms, statistics.median(ms[first:])


def phase_train(cfg):
    """tinyllama-1.1b at full width and depth through the launcher
    (``repro_torch.launch.train --full``): B = 8 x S = 1,024, bf16
    activations, remat, AdamW from the seed.  Every loss finite, no step
    skipped, and the launches a step makes equal to those the model calls
    for, shape by shape (``train_shape_counts``), with no other kernel."""
    steps = TRAIN["steps"]
    mdir = Path(tempfile.mkdtemp(prefix="chip_smoke_metrics_"))
    try:
        metrics = str(mdir / "train.jsonl")
        out, wall, peak = launch_train_run(
            ["--arch", ARCH, "--full", "--steps", str(steps),
             "--metrics-out", metrics, "--metrics-every", "1"])
        lines = validate_jsonl(metrics)
        last = last_snapshot(metrics)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    if (lines["snapshot"] != steps + 1
            or last["counters"]["train.steps"] != steps
            or not np.isfinite(last["gauges"]["train.loss"])):
        raise AssertionError(f"train: metrics {lines}, last snapshot "
                             f"{last['counters']}")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if int(out["state"]["skipped"]) or any(h["ok"] != 1 for h in hist):
        raise AssertionError(f"train: {int(out['state']['skipped'])} "
                             f"skipped steps")
    ms, ms_step = train_steps_summary(hist)
    N = TRAIN["batch"] * TRAIN["seq"]
    want_fused, want_grads = train_shape_counts(cfg, N)
    shapes = shape_counts(TRAIN_LIBRARIES)
    got_fused = {s: n / steps for s, n in shapes.get("bc_fused", {}).items()}
    got_grads = {s: n / steps
                 for s, n in shapes.get("bc_grad_w", {}).items()}
    if got_fused != want_fused or got_grads != want_grads:
        raise AssertionError(f"train: launches a step {got_fused}, "
                             f"{got_grads}; expected {want_fused}, "
                             f"{want_grads}")
    launches = lane_counts(TRAIN_LIBRARIES)
    check_launches(launches, {"bc_fused": steps * sum(want_fused.values()),
                              "bc_grad_w": steps * sum(want_grads.values())})
    emit({"phase": "train", "arch": ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
          "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": steps,
          "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
          "skipped": int(out["state"]["skipped"]), "step_ms": ms,
          "ms_per_step": ms_step, "tokens_per_s": 1e3 * N / ms_step,
          "wall_s": wall, "peak_memory_bytes": peak,
          "params": sum(p.numel() for p in out["state"]["model"].parameters()),
          "launches": launches, "metrics_lines": lines,
          "metrics_train_loss": last["gauges"]["train.loss"],
          "bc_fused_per_step": sum(want_fused.values()),
          "bc_grad_w_per_step": sum(want_grads.values()),
          "launches_per_step_by_shape": {**got_fused, **got_grads}})
    return {"launches": launches, "paths": path_counts(TRAIN_LIBRARIES),
            "shapes": shapes, "ms_per_step": ms_step, "peak": peak}


def launch_train_run(args, batch=TRAIN["batch"], seq=TRAIN["seq"]):
    """``launch.train.main`` with every launch count set to 0 just before
    (in a temporary workdir, removed after): (its result, wall seconds,
    peak device memory).  What earlier phases left is collected first, so
    the peak is the run's own (above the few hundred MB the kernels' DFT
    panels and the CUDA context keep)."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for lib in TRAIN_LIBRARIES:
            lib.reset_counts()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = launch_train.main(
            [*args, "--batch", str(batch), "--seq", str(seq),
             "--log-every", "1", "--workdir", workdir])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_train_parity(cfg):
    """Full width, 2 layers, float32: the card's loss and every parameter's
    gradient against the CPU's plain path on the same weights and batch
    (loss within 1e-5 of its scale, each gradient within 1e-4 of its own:
    float32 sums in other orders).  Then the trainer on the card: 2 steps
    in one run against 1 step, a checkpoint, a new trainer that restores
    it and takes step 2: every tensor of the two states equal."""
    pcfg = cfg.replace(num_layers=2, dtype="float32")
    opt = adamw.AdamWConfig(lr=1e-3)
    data = SyntheticLM(pcfg, batch=2, seq=64, seed=SEED)
    batch = data(0)
    step = ts.make_train_step(pcfg, opt)
    cpu = ts.init_state(pcfg, opt, seed=SEED, device="cpu")
    card = ts.init_state(pcfg, opt,
                         model=copy.deepcopy(cpu["model"]).to(DEVICE))
    loss_c, _, grads_c = step.grads(cpu, batch)
    loss_g, _, grads_g = step.grads(card, {k: v.to(DEVICE)
                                           for k, v in batch.items()})
    loss_err = abs(float(loss_g) - float(loss_c))
    if not loss_err <= 1e-5 * max(1.0, abs(float(loss_c))):
        raise AssertionError(f"train_parity: loss {float(loss_g)} vs "
                             f"{float(loss_c)}")
    worst = {}
    for leaf, gc, gg in zip(ts.param_leaves(cpu["model"], pcfg), grads_c,
                            grads_g):
        for i, (a, b) in enumerate(zip(gc, gg)):
            scale = float(a.abs().max())
            worst[f"{leaf.name}/{i}"] = max_err(b.cpu(), a) / max(scale,
                                                                  1e-30)
    bad = {n: e for n, e in worst.items() if not e <= 1e-4}
    if bad:
        raise AssertionError(f"train_parity: grads over 1e-4 of their "
                             f"scale: {bad}")

    def trainer(workdir, steps):
        return Trainer(pcfg, opt, workdir=workdir, data_fn=data,
                       total_steps=steps, ckpt_every=1, log_every=1,
                       lr_schedule=lambda s: schedule.constant(
                           s, peak_lr=opt.lr), device=DEVICE, seed=SEED)

    dirs = [tempfile.mkdtemp(prefix="chip_smoke_resume_") for _ in range(2)]
    try:
        whole = trainer(dirs[0], 2).run()
        trainer(dirs[1], 1).run()
        resumed = trainer(dirs[1], 2)
        if int(resumed.init_or_restore()["step"]) != 1:
            raise AssertionError("train_parity: resume did not find step 1")
        again = resumed.run()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    diffs = {n: max_err(a.detach(), b.detach()) for (n, a), (_, b) in zip(
        tckpt.named_tensors(whole), tckpt.named_tensors(again))
        if a.is_floating_point()}
    equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tckpt.named_tensors(whole), tckpt.named_tensors(again)))
    emit({"phase": "train_parity", "arch": ARCH, "layers": 2,
          "d_model": pcfg.d_model, "batch": 2, "seq": 64,
          "loss_card": float(loss_g), "loss_cpu": float(loss_c),
          "loss_abs_err": loss_err,
          "grad_worst_rel_err": max(worst.values()),
          "grad_worst": max(worst, key=worst.get), "grad_tol_rel": 1e-4,
          "resume_equal": equal,
          "resume_max_abs_diff": max(diffs.values()),
          "resumed_step": int(again["step"])})
    if not equal:
        raise AssertionError(f"train_parity: resumed state differs "
                             f"({max(diffs.values())})")


def phase_train_dense(cfg, circulant):
    """The same training at the same shape and depth with ``--no-compress``
    (dense projections, bf16 matmuls): ms per step and peak memory beside
    the circulant run's.  No checkpoints: a dense state's 13 GB would take
    most of the phase to write."""
    steps = TRAIN["dense_steps"]
    out, wall, peak = launch_train_run(
        ["--arch", ARCH, "--full", "--no-compress", "--steps", str(steps),
         "--ckpt-every", "0"])
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train_dense: losses {losses}")
    ms, ms_step = train_steps_summary(hist, first=1)
    N = TRAIN["batch"] * TRAIN["seq"]
    emit({"phase": "train_dense", "arch": ARCH, "steps": steps,
          "losses": losses, "step_ms": ms, "ms_per_step": ms_step,
          "tokens_per_s": 1e3 * N / ms_step, "wall_s": wall,
          "peak_memory_bytes": peak,
          "params": sum(p.numel() for p in out["state"]["model"].parameters()),
          "launches": lane_counts(TRAIN_LIBRARIES),
          "circulant_ms_per_step": circulant["ms_per_step"],
          "circulant_over_dense_time": circulant["ms_per_step"] / ms_step,
          "circulant_peak_memory_bytes": circulant["peak"]})


def train_expected(cfg, model):
    """The launches one training step makes, derived from the model: every
    block-circulant projection's forward (twice under remat: each group's
    forward runs again in the backward; once for whisper's cross K/V,
    computed outside the checkpoint from the encoder output, as ``repro``
    does) and its adjoint through ``bc_fused``, its weight gradient through
    ``bc_grad_w``; an expert stack the same, each of its three projections
    one launch or call for all E experts (the ``experts`` path).  Returns
    ({lane: launches}, {lane: experts-path launches})."""
    fwd = 2 if cfg.remat == "full" else 1
    fused = grads = stacks = 0
    for name, mod in model.named_modules():
        if isinstance(mod, cc.Linear) and mod.spec.kind == "block_circulant":
            once = ".cross.k" in name or ".cross.v" in name
            fused += (1 if once else fwd) + 1
            grads += 1
        elif isinstance(mod, ffn.Experts) and mod.block_size:
            stacks += len(ffn.EXPERT_PROJECTIONS)
    return ({"bc_fused": fused + stacks * (fwd + 1),
             "bc_grad_w": grads + stacks},
            {"bc_fused": stacks * (fwd + 1), "bc_grad_w": stacks})


def phase_train_arch(arch):
    """One arch past ``attn`` blocks through the launcher (``--full``,
    llama4 with ``--layers``), ``TRAIN_ARCHS``' tokens and steps, bf16,
    remat, AdamW from the seed, no checkpoints: every loss finite, no step
    skipped, ms a step (the median after the first), tokens/s, peak
    memory, and the launches a step by lane, path and shape.  They must
    equal ``train_expected``'s (no other kernel: attention trains through
    the plain masked softmax); an MoE's expert stacks take one ``bc_fused``
    launch a projection and pass and one ``bc_grad_w`` call a projection,
    at the shapes ``train_stack_shapes`` names."""
    t = TRAIN_ARCHS[arch]
    steps = t["steps"]
    args = ["--arch", arch, "--full", "--steps", str(steps),
            "--ckpt-every", "0"]
    if "layers" in t:
        args += ["--layers", str(t["layers"])]
    out, wall, peak = launch_train_run(args, t["batch"], t["seq"])
    cfg = get_config(arch)
    if "layers" in t:
        cfg = cfg.replace(num_layers=t["layers"])
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{t['phase']}: losses {losses}")
    if int(out["state"]["skipped"]) or any(h["ok"] != 1 for h in hist):
        raise AssertionError(f"{t['phase']}: skipped steps")
    ms, ms_step = train_steps_summary(hist, first=1)
    want, want_experts = train_expected(cfg, out["state"]["model"])
    launches = lane_counts(TRAIN_LIBRARIES)
    check_launches(launches, {lane: steps * n for lane, n in want.items()})
    paths = path_counts(TRAIN_LIBRARIES)
    got_experts = {lane: paths.get(lane, {}).get("experts", 0) / steps
                   for lane in want_experts}
    if got_experts != want_experts:
        raise AssertionError(f"{t['phase']}: expert-stack launches a step "
                             f"{got_experts}, expected {want_experts}")
    shapes = shape_counts(TRAIN_LIBRARIES)
    by_shape = {f"{lib}:{key}": n / steps for lib, per in shapes.items()
                for key, n in per.items()}
    tokens = t["batch"] * t["seq"]
    stack_shapes = {}
    if cfg.moe.num_experts:
        G, cap = moe_capacity(cfg, tokens)
        fam = "llama4" if arch == MOE else "mixtral"
        moe_layers = want_experts["bc_grad_w"] // 3
        fwd = 2 if cfg.remat == "full" else 1
        for name, (E, C, p, q, k) in train_stack_shapes().items():
            if not name.startswith(fam):
                continue
            # bc_fused: each projection's forward (fwd times) at (p, q)
            # and its adjoint at (q, p); up/gate's adjoint shares down's
            # forward shape and down's adjoint up/gate's
            per = {"bc_grad_w": shapes["bc_grad_w"].get(
                bgw.shape_key(C, p, q, k, E), 0) / steps,
                "bc_fused": shapes["bc_fused"].get(bc_fused.shape_key(
                    E, C, p, q, k, "bc_fused"), 0) / steps}
            mult = 2 if name.endswith("up_gate") else 1
            wanted = {"bc_grad_w": mult * moe_layers,
                      "bc_fused": moe_layers * (mult * fwd + 3 - mult)}
            if per != wanted:
                raise AssertionError(f"{t['phase']}: {name} launches a "
                                     f"step {per}, expected {wanted}")
            stack_shapes[name] = {"E": E, "C": C, "G": G, "cap": cap, **per}
    emit({"phase": t["phase"], "arch": arch, "layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers or None,
          "reduced": ({"num_layers": [get_config(arch).num_layers,
                                      cfg.num_layers]}
                      if "layers" in t else None),
          "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
          "batch": t["batch"], "seq": t["seq"], "tokens_per_step": tokens,
          "window": cfg.attention.sliding_window or None, "steps": steps,
          "losses": losses, "moe_aux": [h.get("moe_aux") for h in hist],
          "grad_norms": [h["grad_norm"] for h in hist],
          "skipped": int(out["state"]["skipped"]), "step_ms": ms,
          "ms_per_step": ms_step, "tokens_per_s": 1e3 * tokens / ms_step,
          "wall_s": wall, "peak_memory_bytes": peak,
          "params": sum(p.numel() for p in out["state"]["model"].parameters()),
          "launches": launches, "launches_per_step": want,
          "expert_stack_launches_per_step": want_experts,
          "expert_stacks": stack_shapes,
          "launches_per_step_by_shape": by_shape})
    del out
    torch.cuda.empty_cache()
    return {"launches": launches, "paths": paths, "shapes": shapes,
            "ms_per_step": ms_step, "peak": peak}


def phase_train_parity_arch(arch):
    """``phase_train_parity``'s gradient check for an arch past ``attn``
    blocks: 2 layers (whisper 2 + 2) at the published widths, float32,
    2 x 64 tokens (whisper's over its 1,500 frames), the card's loss,
    aux and every parameter's gradient against the CPU's plain path on
    the same weights and batch (loss and aux within 1e-5 of their scale,
    each gradient within 1e-4 of its own: float32 sums in other
    orders)."""
    pcfg = get_config(arch).replace(num_layers=2, dtype="float32")
    if pcfg.is_encoder_decoder:
        pcfg = pcfg.replace(encoder_layers=2)
    opt = adamw.AdamWConfig(lr=1e-3)
    batch = SyntheticLM(pcfg, batch=2, seq=64, seed=SEED)(0)
    step = ts.make_train_step(pcfg, opt)
    cpu = ts.init_state(pcfg, opt, seed=SEED, device="cpu")
    card = ts.init_state(pcfg, opt,
                         model=copy.deepcopy(cpu["model"]).to(DEVICE))
    loss_c, m_c, grads_c = step.grads(cpu, batch)
    loss_g, m_g, grads_g = step.grads(card, {k: v.to(DEVICE)
                                             for k, v in batch.items()})
    errs = {key: abs(float(m_g[key]) - float(m_c[key]))
            / max(1.0, abs(float(m_c[key]))) for key in ("loss", "moe_aux")}
    tol = 1e-4
    worst = {}
    for leaf, gc, gg in zip(ts.param_leaves(cpu["model"], pcfg), grads_c,
                            grads_g):
        for i, (a, b) in enumerate(zip(gc, gg)):
            worst[f"{leaf.name}/{i}"] = max_err(b.cpu(), a) / max(
                float(a.abs().max()), 1e-30)
    name = max(worst, key=worst.get)
    emit({"phase": "train_parity", "arch": arch, "layers": 2,
          "encoder_layers": pcfg.encoder_layers or None,
          "d_model": pcfg.d_model, "batch": 2, "seq": 64,
          "loss_card": float(loss_g), "loss_cpu": float(loss_c),
          "moe_aux_card": float(m_g["moe_aux"]),
          "moe_aux_cpu": float(m_c["moe_aux"]), "rel_errs": errs,
          "grad_worst_rel_err": worst[name], "grad_worst": name,
          "grad_tol_rel": tol, "leaves": len(worst)})
    bad = {n: e for n, e in worst.items() if not e <= tol}
    if bad or not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"train_parity {arch}: loss/aux {errs}, grads "
                             f"over {tol} of their scale: {bad}")
    del cpu, card, grads_c, grads_g
    torch.cuda.empty_cache()


def phase_lowering(cfg, gen):
    """One projection at N = 2048 rows (tinyllama-1.1b's batch prefill),
    device times (CUDA-graph replay) of three lowerings: the hook path (DFT
    product, ``spectral_matmul`` on views of the spectra and the planes,
    iDFT product: no copy between them), ``bc_fused``, and dense
    ``torch.matmul`` against the materialized W.  The hook path's parts
    are timed one by one as well."""
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
        views = ([t.view(-1, q, kf).permute(2, 0, 1) for t in (xr, xi)]
                 + [cache[n].permute(2, 1, 0) for n in ("wr", "ws1", "ws2")])
        ybr, ybi = kops.spectral_contract(xr, xi, cache)
        parts = {
            "dft": lambda: cc.rfft_planes(xb, k),
            "spectral_matmul": lambda: sm.spectral_matmul(*views),
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


def check_bc_experts(cfg, gen, C=4, prefix="llama4"):
    """An expert stack's projection as ``bc_expert_linear`` launches it at
    serve_moe's decode (every expert's dropless buffer of C = 4 rows at 4
    slots): the up/gate projection of all E = 128 experts, one launch on
    each plane lane.  It must equal the per-expert loop (the parent tree's
    path, timed beside it as ``loop_*``) bit for bit, and its replay from a
    CUDA graph the eager call; the error is against the plain version
    expert by expert.  Library: one ``torch.bmm`` against the dense
    (E, n_in, n_out) float32 stack, built here and freed after."""
    E, k = cfg.moe.num_experts, cfg.compression.block_for("expert")
    n_in, n_out = cfg.d_model, cfg.d_ff
    w = torch.stack([cc.init_block_circulant(n_in, n_out, k, generator=gen,
                                             device="cuda")
                     for _ in range(E)])
    E, p, q, _ = w.shape
    planes = cc.spectral_cache(w)
    x = torch.randn((E, C, n_in), generator=gen, device="cuda")
    xb = cc._blockify(x, q, k).contiguous()
    dense = torch.empty((E, n_in, n_out), device="cuda")
    for e in range(E):
        dense[e] = cc.materialize_dense(w[e], n_out, n_in).T
    library_ms = time_ms(lambda: torch.bmm(x, dense))
    del dense, w
    torch.cuda.empty_cache()
    variants = {"bc_fused": ((planes["wr"], planes["ws1"], planes["ws2"]),
                             None)}
    for bits, lane in ((8, "bc_fused_i8"), (4, "bc_fused_i4")):
        qp = codec.quantize_plane_cache(planes, bits)
        variants[lane] = ((qp["wr"], qp["ws1"], qp["ws2"]),
                          [qp[n + "_s"] for n in ("wr", "ws1", "ws2")])
    out = {}
    for lane, (pl, scales) in variants.items():
        per = lambda e: (*(t[e] for t in pl), k,  # noqa: E731
                         None if scales is None else [s[e] for s in scales])
        call = lambda: bc_fused.bc_fused_matmul(xb, *pl, k,  # noqa: E731
                                                scales)
        loop = lambda: torch.stack([  # noqa: E731
            bc_fused.bc_fused_matmul(xb[e], *per(e)) for e in range(E)])
        plain = lambda: torch.stack([  # noqa: E731
            bc_fused.bc_fused_matmul_plain(xb[e], *per(e))
            for e in range(E)])
        before = bc_fused.KERNEL.fn_launches[lane]
        got = call()
        if bc_fused.KERNEL.fn_launches[lane] != before + 1:
            raise AssertionError(f"{lane}: the expert stack took "
                                 f"{bc_fused.KERNEL.fn_launches[lane] - before}"
                                 f" launches")
        want = loop()
        ref = plain()
        torch.cuda.synchronize()
        loop_equal = torch.equal(got, want)
        graph_equal = replay_equal(lambda: (call(),), (got,))
        if not (loop_equal and graph_equal):
            raise AssertionError(f"{lane} expert stack: per-expert loop "
                                 f"{loop_equal}, graph replay {graph_equal}")
        nbytes, flops = fused_work(C, p, q, k, lane, E=E)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        loop_t = kernel_times(loop)
        out[lane] = ([{
            "case": f"{prefix}_experts_up_gate_e{E}_c{C}",
            "shape": [E, C, p, q, k],
            "launch_shape": bc_fused.shape_key(E, C, p, q, k, lane),
            "launch_args": list(bc_fused.launch_args(C, p, q, k, lane, E)),
            "planes": str(pl[0].dtype).split(".")[-1],
            "loop_equal": loop_equal, "graph_equal": graph_equal,
            "max_abs_err": max_err(got, ref),
            "tol": 1e-4 * max(1.0, float(ref.abs().max())),
            **kernel_times(call),
            "loop_ms": loop_t["kernel_ms"],
            "loop_device_ms": loop_t["device_ms"],
            "plain_ms": time_ms(plain, reps=3, inner=1, warmup=1),
            "plain": "bc_fused_matmul_plain expert by expert",
            "library_ms": library_ms,
            "library": "torch.bmm against the dense (E, n_in, n_out) "
                       "float32 stack",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by}], None)
        del got, want, ref
    return out


def kernel_gen():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return gen


def expert_projections(cfg):
    """llama4's projections at the shapes tinyllama-1.1b's lack (its q/o,
    k/v and dense MLP), the experts' among them: an expert's up/gate and
    down have the dense MLP's shapes."""
    return {f"llama4_{'expert_' if name in ('up_gate', 'down') else ''}"
            f"{name}": io for name, io in projections(cfg).items()}


def phase_kernels(cfg):
    gen = kernel_gen()
    qwen = {arch: get_config(arch) for arch in QWEN}
    phi3, moe = get_config(PHI3), get_config(MOE)
    k = cfg.compression.block_attn
    checks = [lambda: check_bc_fused(cfg, gen),
              lambda: check_flash(cfg, gen),
              lambda: check_flash_decode(cfg, gen),
              lambda: check_paged(cfg, gen),
              lambda: check_gather(cfg, gen),
              lambda: check_spectral(cfg, gen),
              # projection fusion's shapes: bc_fused on all three lanes
              # and the batch prefill's MAC at P = 20 and 88
              lambda: check_bc_fused(cfg, gen, fused_projections(cfg)),
              lambda: check_spectral(cfg, gen, [
                  (name, *io, k)
                  for name, io in fused_projections(cfg).items()])]
    for qc in qwen.values():                 # the shapes qwen adds
        family = qc.name.split("-")[0]
        checks += [
            lambda qc=qc: check_bc_fused(qc, gen, new_projections(qc),
                                         lane_names=("bc_fused",)),
            lambda qc=qc, f=family: check_paged(qc, gen, pick=(0,),
                                                prefix=f"{f}_"),
            # head dim 128: the other tensor-core tiling of the bf16 lane
            lambda qc=qc, f=family: check_flash(qc, gen, prefix=f"{f}_"),
            lambda qc=qc, f=family: check_flash_decode(qc, gen,
                                                       prefix=f"{f}_")]
    at = decode_shapes(PHI3)
    checks += [
        # head dim 96: the bf16 lane's third tiling, at a serve_phi3
        # prompt's length; the float32 lane at the oracle's prompt; decode
        # at serve_phi3's last step (paged: G = 1)
        lambda: check_flash(phi3, gen, prefix="phi3_", s_bf16=640,
                            s_f32=600),
        lambda: check_flash_decode(phi3, gen, prefix="phi3_", B=at["rows"],
                                   Skv=at["keys"]),
        lambda: check_paged(phi3, gen, prefix="phi3_", maxp=at["maxp"],
                            positions=at["positions"]),
        lambda: check_bc_fused(phi3, gen, {"phi3_up_gate": (
            phi3.d_model, phi3.d_ff)}, batches=(8,)),
        # a decode's dropless expert buffer at 4 slots: 4 rows an expert
        lambda: check_bc_fused(moe, gen, expert_projections(moe),
                               batches=(4,)),
        # ... and all 128 of them in the one launch serve_moe makes
        lambda: check_bc_experts(moe, gen)]
    whisper, xlstm = batch_arch_projections()
    wk = get_config(WHISPER).compression.block_attn
    checks += [
        # the batch-only archs: flash at their masks and shapes, bc_fused
        # at their decode projections (4 rows), mixtral's expert stack (8
        # experts, top-2: 4 rows each at 4 rows), spectral_matmul at
        # whisper's encoder rows (4 x 1,500)
        lambda: check_batch_archs_attention(gen),
        lambda: check_bc_fused(cfg, gen, {**whisper, **xlstm}, batches=(4,),
                               lane_names=("bc_fused",)),
        lambda: check_bc_experts(get_config(MIXTRAL), gen, prefix="mixtral"),
        lambda: check_spectral(cfg, gen, [(n, *io, wk)
                                          for n, io in whisper.items()],
                               N=4 * 1500)]
    gemma = gemma_projections()
    checks += [
        # head dim 256: every flash lane at gemma2's and recurrentgemma's
        # shapes, bc_fused at their decode projections (4 rows),
        # spectral_matmul at their batch prefills' rows
        lambda: check_head_dim_256(gen),
        lambda: check_bc_fused(cfg, gen, gemma, batches=(4,),
                               lane_names=("bc_fused",))]
    for arch in (GEMMA2, RGEMMA):
        family = arch.split("-")[0]
        bk = get_config(arch).compression.block_attn
        checks.append(lambda family=family, bk=bk, arch=arch: check_spectral(
            cfg, gen, [(n, *io, bk) for n, io in gemma.items()
                       if n.startswith(family + "_")],
            N=4 * BATCH_ARCH[arch]["hi"], timing=LONG))
    # the lanes the padded tiles and group tiles opened: flash at
    # serve_smoke's D = 32 and at public widths no config reaches; paged
    # decode at D = 256 (the wide tile) and G = 71 (group tiles of 16) on
    # both pool lanes, and at serve_smoke's last decode step (D = 32)
    ta = get_smoke_config(ARCH).attention
    checks += [lambda: check_new_flash(gen)] + [
        lambda name=name: check_paged(
            None, gen, prefix=f"{name}_", maxp=NEW_LANES["paged_maxp"],
            positions=NEW_LANE_POSITIONS, heads=NEW_LANES[name],
            pick=(0, 2), plain_timing=LONG) for name in ("d256", "g71")] + [
        lambda: check_paged(
            None, gen, prefix="smoke_", maxp=-(-_SMOKE_SEQ // SMOKE["page"]),
            positions=tuple(len(r.prompt) + r.max_new_tokens - 2
                            for r in _SMOKE_REQS),
            heads=(ta.num_heads, ta.num_kv_heads, ta.head_dim), pick=(0,),
            plain_timing=LONG)]
    checks += [
        # training (phase train): bc_grad_w at each projection's shape,
        # bc_fused at the forward and adjoint shapes, N = 8 x 1,024 rows
        lambda: check_bc_grad_w(cfg, gen),
        lambda: check_bc_fused(cfg, gen, train_kernel_shapes(cfg),
                               batches=(TRAIN_ROWS,),
                               lane_names=("bc_fused",), timing=LONG),
        # training an expert stack (train_mixtral, train_llama4): the
        # bc_grad_w stack lane, bc_fused's stack forward and adjoint
        lambda: check_train_stacks(gen),
        # the 4-product lane (nogauss): its three plane lanes, the
        # training rows, an expert stack and the adjoint
        lambda: check_bc_fused4(cfg, gen)]
    out = {}
    for check in checks:
        record_kernels(out, check())
    return out


def record_kernels(out, groups):
    """Each group's cases into ``out`` (group -> (cases, main case)): the
    share of the bound each reached, one ``kernels`` line a group, and
    every case within its tolerance."""
    for lane, (cases, main_case) in groups.items():
        if not cases:
            continue
        for c in cases:                      # share of the bound reached
            c["bound_share"] = (c["bound_ms"] / c["device_ms"]
                                if c.get("device_ms") else None)
        out.setdefault(lane, ([], main_case))[0].extend(cases)
        emit({"phase": "kernels", "kernel": lane, "cases": cases})
        bad = [c["case"] for c in cases if not c["max_abs_err"] <= c["tol"]]
        if bad:
            raise AssertionError(f"{lane}: over tolerance in {bad}")


# ---------------------------------------------------------------------------
# serve: the main path, full width, with exact launch counts
# ---------------------------------------------------------------------------
def make_requests(cfg, n, lo, hi, new_tokens, rng):
    lens = rng.randint(lo, hi + 1, size=n)
    lens[0], lens[-1] = lo, hi                # cover both ends
    return [Request(prompt=rng.randint(0, cfg.vocab_size, size=int(s))
                    .astype(np.int32), max_new_tokens=new_tokens, id=i)
            for i, s in enumerate(lens)]


def arch_requests(cfg, lo, hi, new, **_):
    """serve_arch's requests: a one-request warm-up, then 4 of ``lo``-``hi``
    prompt tokens and ``new`` new tokens (random, from the seed)."""
    rng = np.random.RandomState(SEED)
    return (make_requests(cfg, 1, lo, lo, 2, rng),
            make_requests(cfg, 4, lo, hi, new, rng))


def decode_shapes(arch):
    """The decode attention shapes of serve_arch's run of ``arch`` at its
    last decode step: the continuous engine's table width and each slot's
    position (prompt + new - 2), the batch engine's rows and keys (the
    longest prompt + new - 1)."""
    s = SERVE_ARCH[arch]
    _, reqs = arch_requests(get_config(arch), **s)
    lens = [len(r.prompt) for r in reqs]
    if len(reqs) != SLOTS:
        raise AssertionError(f"{len(reqs)} requests for {SLOTS} slots")
    return {"maxp": kvc.pages_for(s["max_seq"], PAGE),
            "positions": tuple(n + s["new"] - 2 for n in lens),
            "rows": len(reqs), "keys": max(lens) + s["new"] - 1}


def lane_counts(libs=LIBRARIES):
    return {fn: n for lib in libs for fn, n in lib.fn_launches.items()}


def path_counts(libs=LIBRARIES):
    """Launches per plan path, by library (those that name their paths)."""
    return {lib.name: dict(lib.path_launches) for lib in libs
            if lib.path_launches}


def shape_counts(libs=LIBRARIES):
    """Launches per shape (the wrappers' ``shape_key``), by library."""
    return {lib.name: dict(lib.shape_launches) for lib in libs
            if lib.shape_launches}


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
            "decode_peak_bytes_est": st["decode_peak_bytes_est"],
            "ms_per_step": 1e3 * st["decode_s"] / max(st["decode_steps"], 1),
            **decode_graphs(st)}


def decode_graphs(st):
    """A continuous engine on the card decodes from the one CUDA graph it
    captured when it was built."""
    if st["decode_graphs"] != 1:
        raise AssertionError(f"{st['decode_graphs']} decode-step captures, "
                             f"expected 1")
    return {"decode_graphs": st["decode_graphs"],
            "decode_capture_s": st["decode_capture_s"]}


# ---------------------------------------------------------------------------
# serve_smoke: the serve launcher's default on the card, all ten archs
# ---------------------------------------------------------------------------
def smoke_requests(cfg):
    """The serve launcher's requests at its defaults but ``SMOKE``'s count
    and budget (prompts of a vision stub's patches plus the largest window
    plus 16-31 tokens, drawn from the seed as it draws them), and its
    engines' max_seq."""
    extra = cfg.num_patches if cfg.frontend == "vision_stub" else 0
    if not cfg.is_encoder_decoder:
        extra += max(window_for(k, cfg) for k in layer_kinds(cfg))
    rng = np.random.RandomState(SEED)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=extra
                                       + rng.randint(16, 32)).astype(
        np.int32), max_new_tokens=SMOKE["new"], id=i)
        for i in range(SMOKE["requests"])]
    return reqs, extra + 64 + SMOKE["new"]


def smoke_engine_run(cfg, params, engine, device, reqs, max_seq):
    """``reqs`` through one engine at the launcher's sizes on ``device``:
    (results, stats, the logits each greedy pick read, in order).  The
    batch engine's rows are its prefill's last positions and every step of
    its decode loop (``dec.greedy``, swapped for the run); the continuous
    engine's its B = 1 prefills' (its decode step is one captured CUDA
    graph on the card, eager on the CPU, so only the prefills are read on
    both)."""
    rows, real = [], dec.greedy

    def tap(logits):
        rows.append(logits.detach().float().cpu())
        return real(logits)

    if engine == "batch":
        eng = Engine(cfg, params, max_batch=SMOKE["max_batch"],
                     max_seq=max_seq, device=device)
        prefill = eng._prefill

        def tapped_prefill(p, batch, cache):
            logits, cache = prefill(p, batch, cache)
            rows.append(logits[:, -1].detach().float().cpu())
            return logits, cache

        eng._prefill = tapped_prefill
        dec.greedy = tap
        try:
            results = eng.generate(reqs)
        finally:
            dec.greedy = real
    else:
        eng = ContinuousEngine(cfg, params, max_slots=SMOKE["max_batch"],
                               max_seq=max_seq, page_size=SMOKE["page"],
                               decode_chunk=SMOKE["chunk"], device=device)
        make = eng._prefill_fn

        def prefill_fn(n_pages):
            fn = make(n_pages)

            def tapped(*args):
                dec.greedy = tap
                try:
                    return fn(*args)
                finally:
                    dec.greedy = real
            return tapped

        eng._prefill_fn = prefill_fn
        results = eng.generate(reqs)
    for r, req in zip(results, reqs):
        if (r["status"] != "FINISHED_BUDGET"
                or r["decode_len"] != req.max_new_tokens):
            raise AssertionError(f"{cfg.name} {engine} on {device}: request "
                                 f"{req.id} {r['status']}, "
                                 f"{r['decode_len']} tokens")
    return results, eng.stats(), rows


def smoke_compare(card, cpu, independent):
    """The card's logit rows against the CPU's, each within
    ``SMOKE_LOGIT_TOL`` of max(1, |CPU row|): all of them where each row
    reads only the prompts (``independent``: the continuous engine's
    prefills), else in order up to and including the first row whose
    greedy tokens differ (a later step reads other tokens on the two
    devices).  Returns the comparison."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} logit rows on the card, "
                             f"{len(cpu)} on the CPU")
    errs, diverged = [], None
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"row {i}: {tuple(a.shape)} on the card, "
                                 f"{tuple(b.shape)} on the CPU, or not "
                                 f"finite")
        scale = max(1.0, float(b.abs().max()))
        errs.append(max_err(a, b) / scale)
        if not errs[-1] <= SMOKE_LOGIT_TOL:
            raise AssertionError(f"logit row {i}: {errs[-1]} of the scale "
                                 f"> {SMOKE_LOGIT_TOL}")
        if not independent and not torch.equal(a.argmax(-1), b.argmax(-1)):
            diverged = i
            break
    return {"rows": len(cpu), "rows_compared": len(errs),
            "tokens_diverged_at_row": diverged,
            "max_rel_err": max(errs), "tol": SMOKE_LOGIT_TOL}


def phase_serve_smoke():
    """The serve launcher's default on the card: each arch's smoke config
    (bf16, head dim 32) from the seed through the batch engine and, for
    the five continuous-servable archs, the continuous engine; each run
    against the same engine on the CPU on the same weights, by logits
    (``smoke_compare``).  Every count is set to 0 before the first card
    run and read after the last (the CPU runs launch nothing): the bf16
    flash kernel at D = 32 and the paged kernel (the smoke configs' D =
    32) must have launched.  Then the launcher itself, as README gives
    it, without ``--device cpu``: exit 0."""
    t0 = time.perf_counter()
    reset_counts()
    out = {"phase": "serve_smoke"}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        if cfg.attention.head_dim != 32 or cfg.dtype != "bfloat16":
            raise AssertionError(f"{arch}: the smoke config is not bf16 at "
                                 f"head dim 32")
        reqs, max_seq = smoke_requests(cfg)
        weights = init_params(cfg, seed=SEED, device="cpu")
        engines = ["batch"] + ([] if kvc.servable_reasons(cfg)
                               else ["continuous"])
        for engine in engines:
            before = lane_counts()
            res, st, card = smoke_engine_run(
                cfg, copy.deepcopy(weights).to(DEVICE), engine, DEVICE,
                reqs, max_seq)
            torch.cuda.synchronize()
            after = lane_counts()
            _, _, cpu = smoke_engine_run(cfg, copy.deepcopy(weights),
                                         engine, "cpu", reqs, max_seq)
            out[f"{arch}/{engine}"] = {
                "prompt_lens": [len(r.prompt) for r in reqs],
                "tokens": sum(r["decode_len"] for r in res),
                "prefills": st["prefills"],
                "decode_steps": st["decode_steps"],
                "launches": {f: after[f] - before.get(f, 0) for f in after
                             if after[f] != before.get(f, 0)},
                **smoke_compare(card, cpu, engine == "continuous")}
    torch.cuda.synchronize()
    run = {"launches": lane_counts(), "paths": path_counts(),
           "shapes": shape_counts()}
    flash = run["shapes"].get("flash_attention", {})
    bf16_d = {int(k.split("/")[0].split("x")[5]) for k in flash
              if "/bfloat16/" in k}
    if not run["paths"].get("flash_attention", {}).get("bf16") or \
            bf16_d != {32}:
        raise AssertionError(f"the bf16 flash lane at D = 32 did not carry "
                             f"the prefills: {run['paths']}, {bf16_d}")
    if not run["launches"].get("paged_attention") or \
            run["launches"].get("paged_attention_i8"):
        raise AssertionError(f"the paged decode took "
                             f"{run['launches']}, not the float pool lane")
    out["wall_s"] = time.perf_counter() - t0
    out.update(run)
    t1 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH]
    p = subprocess.run(cli, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    if p.returncode != 0:
        raise AssertionError(f"{' '.join(cli[1:])}: exit {p.returncode}\n"
                             f"{p.stdout[-2000:]}{p.stderr[-4000:]}")
    out["cli"] = {"argv": cli[1:], "returncode": p.returncode,
                  "wall_s": time.perf_counter() - t1,
                  "stdout_tail": p.stdout.splitlines()[-4:]}
    emit(out)
    return run


_SMOKE_REQS, _SMOKE_SEQ = smoke_requests(get_smoke_config(ARCH))
_SMOKE_S = max(len(r.prompt) for r in _SMOKE_REQS)
# the new lanes' cases (check_new_flash, check_paged) on the kernels line:
# (library, the TPU kernel, kernel-check group, case, the run whose
# launches it reports, how): "shape" counts the case's own launch shape in
# that run, "lane" the exported function's launches there (the paged
# decode at the smoke configs' D = 32, the only head dim that run
# serves); "off_path" marks a shape no config reaches, reported with the
# function's launches on that run and its own (none) beside them
SMOKE_LANES = {
    "flash_attention@d32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention",
        f"smoke_prefill_bfloat16_b{SMOKE['requests']}_s{_SMOKE_S}_d32",
        "serve_smoke", "shape"),
    "paged_attention@d32": (
        pa.KERNEL, "src/repro/kernels/paged_attention.py:181",
        "paged_attention", f"smoke_decode_bfloat16_b{SMOKE['max_batch']}",
        "serve_smoke", "lane"),
    "flash_attention@d32_s2048": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", f"prefill_bfloat16_b{NEW_LANES['b32']}_s"
        f"{NEW_LANES['s']}_d32", "serve_smoke", "off_path"),
    "flash_attention@d80": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", f"phi2_prefill_bfloat16_s{NEW_LANES['s']}_d80",
        "serve_smoke", "off_path"),
    "flash_attention@d192_prefill_f32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", f"prefill_float32_s{NEW_LANES['s']}_d192",
        "serve_smoke", "off_path"),
    "flash_attention@d192_decode_f32": (
        fa.KERNEL, "src/repro/kernels/flash_attention.py:75",
        "flash_attention", f"decode_float32_skv{NEW_LANES['skv']}_d192",
        "serve_smoke", "off_path"),
    **{f"paged_attention{i8}@{name}": (
        pa.KERNEL, "src/repro/kernels/paged_attention.py:181",
        f"paged_attention{i8}",
        f"{name}_decode_{'int8_float32' if i8 else 'bfloat16'}_b"
        f"{NEW_LANES['paged_b']}", run, "off_path")
       for name in ("d256", "g71")
       for i8, run in (("", "serve_smoke"), ("_i8", "serve_quant_int8"))}}


def smoke_lane_summary(kernels, runs):
    """The kernels line's entries for ``SMOKE_LANES``."""
    out = []
    for name, (lib, replaces, group, main_case, run, how) in \
            SMOKE_LANES.items():
        c = next(c for c in kernels[group][0] if c["case"] == main_case)
        fn = name.split("@")[0]
        lane = runs[run]["launches"].get(fn, 0)
        shape = c.get("launch_shape")
        at = (runs[run].get("shapes", {}).get(lib.name, {}).get(shape, 0)
              if shape else None)
        launches = at if how == "shape" else lane
        if not launches:
            raise AssertionError(f"{name}: no launch in the {run} run")
        out.append({
            "name": name, "route": "cuda",
            "source": str(lib.source.relative_to(ROOT)),
            "replaces": replaces, "launches": launches, "launches_in": run,
            "lane_launches": lane, "launch_shape": shape,
            "shape_launches": at, "on_main_path": how != "off_path",
            "case": main_case, "max_abs_err": c["max_abs_err"],
            "tol": c["tol"], "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
            "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_us": c["bound_ms"] * 1e3,
            "bound_by": c["bound_by"], "bound_share": c["bound_share"],
            "library_ms": c["library_ms"]})
    return out


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


def projections_per_pass(cfg):
    """(projections the spectral-MAC hook can take, expert launches) in
    one forward pass of a decoder LM: q k v o up gate down of a dense
    layer; q k v o and the shared expert's three of an MoE layer (``moe``
    or mixtral's ``moe_swa``), plus one launch each for up, gate and down
    over all the experts (``repro``'s expert FFN takes no hook); a
    windowed ``attn_local`` layer's as a dense one's; in_x in_gate gate_r
    gate_i out of an RG-LRU and its MLP's three (``rec``); up up_gate q k
    v out of an mLSTM layer, wx out of an sLSTM one.  With
    projection fusion q/k/v are one projection and so are up/gate (the
    shared expert's too; expert stacks never fuse)."""
    kinds = layer_kinds(cfg)
    n_moe = sum(k in ("moe", "moe_swa") for k in kinds)
    fuse = cfg.compression.fuse_projections
    attn, mlp = (2, 2) if fuse else (4, 3)
    shared = mlp if cfg.moe.shared_expert else 0
    per_kind = {"attn": attn + mlp, "attn_local": attn + mlp,
                "moe": attn + shared, "moe_swa": attn + shared,
                "rec": 5 + mlp, "mlstm": 6, "slstm": 2}
    return sum(per_kind[k] for k in kinds), 3 * n_moe


def batch_pass_counts(cfg):
    """Launches of one batch-engine forward pass as (prefill, decode step)
    pairs: ``projections`` the hook can take, ``experts`` (expert-stack
    launches of the fused kernel), ``flash`` (attention layers).  An
    encoder-decoder's prefill also runs the encoder (q k v o up down and
    bidirectional attention a layer) and each decoder layer's cross K/V
    once; its decoder pass is self q k v o, cross q o, up down, and two
    attentions a layer."""
    if cfg.is_encoder_decoder:
        le, ld = cfg.encoder_layers, cfg.num_layers
        return {"projections": (6 * le + 10 * ld, 8 * ld),
                "experts": (0, 0), "flash": (le + 2 * ld, 2 * ld)}
    plain, experts = projections_per_pass(cfg)
    attn = sum(k in tfm.ATTN_KINDS for k in layer_kinds(cfg))
    return {"projections": (plain, plain), "experts": (experts, experts),
            "flash": (attn, attn)}


def continuous_launches(cfg, st, lane="bc_fused"):
    """What one continuous-engine run must launch: every projection of a
    prefill or decode step through the fused kernel's lane, the flash
    kernel once per layer and prefill, the paged kernel once per layer and
    decode step."""
    hooked, experts = projections_per_pass(cfg)
    pre, steps = st["prefills"], st["decode_steps"]
    return {lane: (hooked + experts) * (pre + steps),
            "flash_attention": cfg.num_layers * pre,
            "paged_attention": cfg.num_layers * steps}


def batch_launches(cfg, st, lane="bc_fused", hooked=True):
    """What one batch-engine run must launch (``batch_pass_counts`` a
    prefill and a decode step): every projection of a prefill but the
    experts' through ``spectral_matmul`` (float32 planes, ``hooked``) or
    the fused kernel's lane, the experts' and every decode projection
    through the fused kernel, the flash kernel once per attention layer
    and forward pass."""
    c = batch_pass_counts(cfg)
    (pp, ps), (ep, es), (fp, fs) = c["projections"], c["experts"], c["flash"]
    pre, steps = st["prefills"], st["decode_steps"]
    want = {lane: (ps + es) * steps + (ep if hooked else pp + ep) * pre,
            "flash_attention": fp * pre + fs * steps}
    if hooked:
        want["spectral_matmul"] = pp * pre
    return want


def roofline_fractions(phase, st):
    """The run's per-kind roofline summary on the ``h100`` spec; every
    fraction (least time over measured time) must lie in (0, 1]: a
    reading above 1 means the profiler's counts exceed the work."""
    if st["hardware"] != H100.name:
        raise AssertionError(f"{phase}: priced against {st['hardware']}")
    out = {}
    for kind, r in st["roofline"].items():
        if not r["dispatches"]:
            continue
        lo, hi = r["roofline_frac"], r["roofline_frac_max"]
        if not 0 < lo <= hi <= 1:
            raise AssertionError(f"{phase}: {kind} roofline fraction "
                                 f"{lo} (max {hi}) outside (0, 1]")
        out[kind] = {"dispatches": r["dispatches"], "roofline_frac": lo,
                     "roofline_frac_max": hi, "bound": r["bound"],
                     "flops": r["flops"],
                     "bytes_accessed": r["bytes_accessed"],
                     "achieved_flops_per_s": r["achieved_flops_per_s"],
                     "achieved_bytes_per_s": r["achieved_bytes_per_s"]}
    if not out:
        raise AssertionError(f"{phase}: no profiled dispatch")
    return out


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
    out["roofline"] = roofline_fractions("serve_batch", st)
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
    emit({"phase": "serve_parity", **card_cpu_parity(cfg, SEED + 1)})


def card_cpu_parity(cfg, seed):
    """``cfg`` in float32, one request of 48 + 16 tokens from ``seed``'s
    weights on the card and on the CPU's plain path: prefill logits within
    1e-4 of their scale, greedy tokens equal up to the CPU's first
    near-tie.  Returns the comparison."""
    cfg = cfg.replace(dtype="float32")
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, size=48).astype(np.int32)
    new = 16
    params = {"cpu": init_params(cfg, seed=seed, device="cpu")}
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
    return {"dtype": "float32", "prompt_len": 48,
            "new_tokens": new, "logit_max_abs_err": logit_err,
            "logit_tol": logit_tol, "near_tie": near_tie,
            "tokens_compared": agreed,
            "tokens_equal": toks["card"] == toks["cpu"],
            "min_margin": min(margins), "tokens_card": toks["card"],
            "tokens_cpu": toks["cpu"]}


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
            toks[None], device=dev), **frontend_inputs(cfg, 1, dev)}, cache)
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
def batch_trace(cfg, params, prompt, new, cache_dtype=torch.float32):
    """One request through the batch engine's path by hand (the hooked
    prefill, then greedy decode steps against the dense cache, float32 or
    ``cache_dtype``): (greedy tokens, the logits of every step as a (new,
    V) CPU tensor)."""
    return batch_traces(cfg, params, prompt[None], new, cache_dtype)[0]


def batch_traces(cfg, params, prompts, new, cache_dtype=torch.float32):
    """``batch_trace`` of B prompts of one length (B, S) as one batch:
    one (tokens, logits) pair a row."""
    dev = next(params.parameters()).device
    model = build_model(cfg)
    prefill = dec.make_prefill_step(cfg, kernel_fn=PrefillContract(params))
    step = dec.make_decode_step(cfg)
    B, S = prompts.shape
    with torch.no_grad():
        cache = model.init_cache(B, S + new - 1, dtype=cache_dtype,
                                 device=dev)
        logits, cache = prefill(params, {"tokens": torch.as_tensor(
            prompts, dtype=torch.int64, device=dev),
            **frontend_inputs(cfg, B, dev)}, cache)
        steps = [logits[:, -1].float().cpu()]
        for i in range(new - 1):
            cur = steps[-1].argmax(-1)[:, None].to(dev)
            logits, _, cache = step(params, cur, cache, S + i)
            steps.append(logits[:, -1].float().cpu())
    lg = torch.stack(steps, 1)                       # (B, new, V)
    return [(row.argmax(-1).tolist(), row) for row in lg]


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


def serve_arch(arch, phase, *, lo, hi, new, max_seq, oracle_len, oracle_new):
    """One arch at its published widths and depth, random weights from the
    seed: 4 requests of ``lo``-``hi`` prompt tokens and ``new`` new tokens
    through each engine (after a one-request warm-up; exact launch counts
    per lane), then the B=1 oracle check on one float32 request of
    ``oracle_len`` + ``oracle_new`` tokens, with the smallest gap between
    the two largest router logits of any token an MoE layer routed there
    (``layers/ffn.py:top2_gap``: a gap under the logits' rounding error may
    route otherwise under another lowering).  Returns the phase's line."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    L = cfg.num_layers
    params = init_params(cfg, seed=SEED, device=DEVICE)
    warm, reqs = arch_requests(cfg, lo, hi, new)
    hooked, experts = projections_per_pass(cfg)
    runs = {}
    engines = {
        "batch": lambda: Engine(cfg, params, max_batch=8, max_seq=max_seq,
                                device=DEVICE),
        "continuous": lambda: ContinuousEngine(
            cfg, params, max_slots=SLOTS, max_seq=max_seq, page_size=PAGE,
            decode_chunk=8, device=DEVICE)}
    for name, make in engines.items():
        make().generate(warm)
        results, st, launches, wall, peak = timed_run(make(), reqs)
        pre, steps = st["prefills"], st["decode_steps"]
        want = (batch_launches(cfg, st) if name == "batch"
                else continuous_launches(cfg, st))
        check_launches(launches, want)
        paths = path_counts()
        stacks = paths.get("bc_fused", {}).get("experts", 0)
        if stacks != experts * (pre + steps):
            raise AssertionError(f"{arch} {name}: {stacks} expert-stack "
                                 f"launches, expected {experts} a pass")
        tokens = sum(r["decode_len"] for r in results)
        runs[name] = {
            **(decode_graphs(st) if name == "continuous" else {}),
            "paths": paths,
            "requests": len(results), "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "prefill_s": st["prefill_s"],
            "decode_s": st["decode_s"], "prefills": pre,
            "decode_steps": steps,
            "ms_per_step": 1e3 * st["decode_s"] / max(steps, 1),
            "launches": launches, "peak_memory_bytes": peak,
            "cache_or_pool_bytes": st.get("cache_bytes",
                                          st.get("pool_bytes"))}
    prompt = np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, size=oracle_len).astype(np.int32)
    moes = [m for m in params.modules() if isinstance(m, ffn.MoE)]
    for m in moes:                 # before the oracle's engines capture
        m.logit_gap = torch.full((), float("inf"), device=DEVICE)
    for lib in LIBRARIES:
        lib.reset_counts()
    _, oracle = oracle_check(cfg.replace(dtype="float32"), params, prompt,
                             oracle_new)
    runs["oracle"] = {"launches": lane_counts(), "paths": path_counts()}
    flash = runs["oracle"]["paths"].get("flash_attention", {})
    if cfg.attention.head_dim in fa.F32_MMA_HEAD_DIMS and not flash.get(
            "f32_mma"):
        raise AssertionError(f"{arch}: the float32 oracle's prefills did not "
                             f"take the tensor-core kernel: {flash}")
    if moes:
        oracle["min_router_logit_gap"] = min(float(m.logit_gap)
                                             for m in moes)
    for m in moes:
        m.logit_gap = None
    out = {"phase": phase, "arch": arch, "layers": L,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size,
           "prompt_lens": [len(r.prompt) for r in reqs],
           **runs, "oracle_b1_float32": oracle,
           "bc_fused_per_pass": hooked + experts,
           "expert_launches_per_pass": experts,
           "phase_wall_s": time.perf_counter() - t0,
           "phase_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_qwen():
    """Each qwen model at its published widths and depth through both
    engines, then the B=1 oracle check on one float32 request."""
    return {arch: serve_arch(arch, "serve_qwen", lo=17, hi=200, new=16,
                             max_seq=256, oracle_len=48, oracle_new=16)
            for arch in QWEN}


def phase_serve_phi3():
    """phi-3-vision-4.2b: image-plus-text prompts longer than its 576 patch
    slots, so the zero patches replace a real prefix."""
    return serve_arch(PHI3, "serve_phi3", **SERVE_ARCH[PHI3])


def phase_serve_moe():
    """llama4-maverick-400b-a17b.  The oracle's prompt of 48 tokens fills
    3 pages exactly, so both engines route the same 48 tokens under the
    same capacity."""
    return serve_arch(MOE, "serve_moe", **SERVE_ARCH[MOE])


# ---------------------------------------------------------------------------
# serve_mixtral / serve_xlstm / serve_whisper: the archs only the batch
# engine serves
# ---------------------------------------------------------------------------
def batch_paths(cfg, st):
    """The plan path of every launch in a bf16 batch-engine run of a
    batch-only arch: the fused kernel's expert stacks apart from its
    single projections; flash prefills on the bf16 lane (whisper's
    cross-attention reads the float32 cache: the float32 tensor-core
    kernel, its 4 x 200 rows well above 16), one-row decodes on the float32
    rows kernel."""
    c = batch_pass_counts(cfg)
    pre, steps = st["prefills"], st["decode_steps"]
    (pp, ps), (ep, es) = c["projections"], c["experts"]
    fused = {"experts": ep * pre + es * steps, "single": ps * steps}
    if cfg.is_encoder_decoder:
        le, ld = cfg.encoder_layers, cfg.num_layers
        flash = {"bf16": (le + ld) * pre, "f32_mma": ld * pre,
                 "f32_rows": 2 * ld * steps}
    else:
        fp, fs = c["flash"]
        flash = {"bf16": fp * pre, "f32_rows": fs * steps}
    drop = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    return {lib: drop(d) for lib, d in (("bc_fused", fused),
                                        ("flash_attention", flash))
            if drop(d)}


def reduced_check(cfg, reduced, n):
    """float32 prefill logits at the depth ``reduced`` (full width) on the
    card against the CPU's plain path, the same weights and prompt (and,
    for whisper, the same random frames): within 1e-4 of their scale.  A
    decoder LM runs without a cache (mixtral's ring rule does not apply);
    whisper's prefill fills its cache."""
    rcfg = cfg.replace(dtype="float32", **reduced)
    cpu = precompute_serving_params(
        init_params(rcfg, seed=SEED + 5, device="cpu"), rcfg)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.RandomState(SEED + 5)
    tokens = rng.randint(0, rcfg.vocab_size, size=(1, n))
    frames = (rng.randn(1, rcfg.encoder_seq, rcfg.d_model).astype(np.float32)
              if rcfg.is_encoder_decoder else None)
    model = build_model(rcfg)

    def logits(params, dev):
        toks = torch.as_tensor(tokens, device=dev)
        with torch.no_grad():
            if frames is None:
                out, _ = tfm.forward(params, toks, rcfg,
                                     kernel_fn=kops.spectral_contract)
            else:
                cache = model.init_cache(1, n, dtype=torch.float32,
                                         device=dev)
                out, _ = model.prefill(
                    params, {"tokens": toks, "frames": torch.as_tensor(
                        frames, device=dev)}, cache,
                    kernel_fn=kops.spectral_contract)
        return out.float().cpu()

    t0 = time.perf_counter()
    want = logits(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    got = logits(card, DEVICE)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    err = max_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{cfg.name} at {reduced}: card logits differ "
                             f"from the CPU's by {err} > {tol}")
    del card
    return {"reduced": reduced, "prompt_len": n, "max_abs_err": err,
            "tol": tol, "cpu_s": cpu_s}


def serve_batch_arch(arch, phase, *, lo, hi, new, max_seq, oracle_len,
                     oracle_new, reduced, check_len):
    """An arch only the batch engine serves, at its published widths and
    depth, random weights from the seed: 4 requests of ``lo``-``hi``
    prompt tokens and ``new`` new tokens through ``Engine`` after a
    one-request warm-up, with exact launch counts per lane and per plan
    path (``batch_paths``); then the B=1 float32 oracle (the engine's
    tokens equal a hand-run ``batch_trace``; its launches counted apart),
    then ``reduced_check``.  Returns the phase's line."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    warm, reqs = arch_requests(cfg, lo, hi, new)
    Engine(cfg, params, max_batch=8, max_seq=max_seq,
           device=DEVICE).generate(warm)
    results, st, launches, wall, peak = timed_run(
        Engine(cfg, params, max_batch=8, max_seq=max_seq, device=DEVICE),
        reqs)
    check_launches(launches, batch_launches(cfg, st))
    paths = path_counts()
    if paths != batch_paths(cfg, st):
        raise AssertionError(f"{arch}: launches by plan path {paths}, "
                             f"expected {batch_paths(cfg, st)}")
    counts = batch_pass_counts(cfg)
    pre, steps = st["prefills"], st["decode_steps"]
    tokens = sum(r["decode_len"] for r in results)
    runs = {"batch": {
        "paths": paths, "shapes": shape_counts(),
        "requests": len(results), "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
        "prefills": pre, "decode_steps": steps,
        "ms_per_prefill": 1e3 * st["prefill_s"] / max(pre, 1),
        "ms_per_step": 1e3 * st["decode_s"] / max(steps, 1),
        "launches": launches, "peak_memory_bytes": peak,
        "cache_bytes": st["cache_bytes"],
        "padded_prompt_tokens": st["padded_prompt_tokens"]}}
    prompt = np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, size=oracle_len).astype(np.int32)
    cfg32 = cfg.replace(dtype="float32")
    for lib in LIBRARIES:
        lib.reset_counts()
    trace = batch_trace(cfg32, params, prompt, oracle_new)
    got = generate_one(Engine(cfg32, params, max_batch=1,
                              max_seq=oracle_len + oracle_new,
                              device=DEVICE), prompt, oracle_new)
    if got != trace[0]:
        raise AssertionError(f"{arch}: the B=1 engine's {got} against its "
                             f"hand-run path's {trace[0]}")
    runs["oracle"] = {"launches": lane_counts(), "paths": path_counts(),
                      "shapes": shape_counts(),
                      "prompt_len": oracle_len, "new_tokens": oracle_new,
                      "tokens": got}
    flash = runs["oracle"]["paths"].get("flash_attention", {})
    if counts["flash"][0] and not flash.get("f32_mma"):
        raise AssertionError(f"{arch}: the float32 oracle's prefills did not "
                             f"take the tensor-core kernel: {flash}")
    del params
    torch.cuda.empty_cache()
    out = {"phase": phase, "arch": arch, "engine": "batch",
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "launches_per_pass": {
               "prefill": {"projections": counts["projections"][0],
                           "expert_stacks": counts["experts"][0],
                           "flash_attention": counts["flash"][0]},
               "decode_step": {"projections": counts["projections"][1],
                               "expert_stacks": counts["experts"][1],
                               "flash_attention": counts["flash"][1]}},
           **runs, "oracle_b1_float32_equals_trace": True,
           "card_vs_cpu": reduced_check(cfg, reduced, check_len),
           "phase_wall_s": time.perf_counter() - t0,
           "phase_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return out


def phase_serve_batch_archs():
    """mixtral-8x7b (every layer sliding-window attention over a ring
    cache, then 8 experts top-2), xlstm-125m (mLSTM / sLSTM cells, no
    attention), whisper-large-v3 (32 + 32 layers, 1,500 zero frames,
    cross-attention over the cached encoder K/V), gemma2-9b (42 layers
    alternating a window of 4,096 over a ring cache and global attention
    over a linear one, head dim 256, softcaps 50 and 30, sandwich norms)
    and recurrentgemma-2b (26 layers: (RG-LRU, RG-LRU, window of 2,048) x
    8 then two RG-LRU; 10 query heads on one KV head of 256)."""
    return {arch: serve_batch_arch(arch, f"serve_{arch.split('-')[0]}",
                                   **BATCH_ARCH[arch])
            for arch in (MIXTRAL, XLSTM, WHISPER, GEMMA2, RGEMMA)}


# ---------------------------------------------------------------------------
# serve_fused: projection fusion (q/k/v and up/gate as one bc_fused launch)
# ---------------------------------------------------------------------------
FUSED_PARITY = {ARCH: (48, 16), QWEN[0]: (48, 16), QWEN[1]: (48, 16),
                PHI3: (SERVE_ARCH[PHI3]["oracle_len"],
                       SERVE_ARCH[PHI3]["oracle_new"]),
                MOE: (SERVE_ARCH[MOE]["oracle_len"],
                      SERVE_ARCH[MOE]["oracle_new"])}


def fused(cfg):
    return cfg.with_compression(fuse_projections=True)


def plane_bytes(cfg, policy):
    """Bytes of every baked plane (and scale) of ``cfg``'s params on the
    card under ``policy``: fresh random weights from the seed."""
    params = precompute_serving_params(
        init_params(cfg, seed=SEED, device=DEVICE), cfg, policy)
    n = sum(t.numel() * t.element_size()
            for _, _, _, c in codec.baked_caches(params) for t in c.values())
    del params
    torch.cuda.empty_cache()
    return n


def unbake_fused(params):
    """Drop the planes of the projections fusion shadows (q/k/v, up/gate),
    so that the same weights can be baked fused in place."""
    for m in params.modules():
        if isinstance(m, cc.FusedProjections):
            for lin in m.fused_linears():
                if lin is not None:
                    for key in cc.CACHE_KEYS:
                        setattr(lin, f"wc_cache_{key}", None)
    torch.cuda.empty_cache()


def fused_parity(arch):
    """One float32 request of ``arch`` at its published widths, unfused
    then fused on the same weights, through the serving path by hand
    (``greedy_trace``): prefill logits within 1e-4 of their scale and
    greedy tokens equal up to the first near-tie.  llama4's weights are
    re-baked fused in place (two copies do not fit the card)."""
    cfg = get_config(arch).replace(dtype="float32")
    n, new = FUSED_PARITY[arch]
    prompt = np.random.RandomState(SEED + 5).randint(
        0, cfg.vocab_size, size=n).astype(np.int32)
    policy = codec.QuantPolicy()
    params = precompute_serving_params(
        init_params(cfg, seed=SEED + 5, device=DEVICE), cfg)
    plain = greedy_trace(cfg, params, prompt, new, policy, "stream")
    if arch == MOE:
        unbake_fused(params)
    else:
        del params
        torch.cuda.empty_cache()
        params = init_params(cfg, seed=SEED + 5, device=DEVICE)
    params = precompute_serving_params(params, fused(cfg))
    for lib in LIBRARIES:
        lib.reset_counts()
    got = greedy_trace(fused(cfg), params, prompt, new, policy, "stream")
    per_pass = sum(projections_per_pass(fused(cfg)))
    if bc_fused.KERNEL.launches != per_pass * new:
        raise AssertionError(f"{arch} fused: {bc_fused.KERNEL.launches} "
                             f"bc_fused launches over {new} passes, "
                             f"expected {per_pass} a pass")
    del params
    torch.cuda.empty_cache()
    # float32 through every layer, the fused planes' MAC summing the same
    # terms as the unfused ones': ~1e-6 of the logit scale, held at 1e-4
    tol = 1e-4 * max(1.0, float(plain[1][0].abs().max()))
    err = max_err(got[1][0], plain[1][0])
    if not err <= tol:
        raise AssertionError(f"{arch}: fused prefill logits differ by {err} "
                             f"> {tol}")
    return {"prompt_len": n, "new_tokens": new, "prefill_logit_max_abs_err":
            err, "tol": tol, "bc_fused_per_pass": per_pass,
            **compare_traces(got, plain, tol), "tokens_fused": got[0],
            "tokens_unfused": plain[0]}


def phase_serve_fused(cfg):
    """tinyllama-1.1b at full width and depth with ``fuse_projections``:
    the serve phase's 16 requests through the continuous engine and the
    batch engine, on float32 planes, then int8 and int4 planes (an int8
    pool): exact launch counts (88 ``bc_fused`` a forward pass; the batch
    prefill's MAC through ``spectral_matmul`` at P = 20 and 88), plane bytes
    equal to the unfused engine's; then the fused-against-unfused check on
    one float32 request of each paged-servable arch."""
    t0 = time.perf_counter()
    fcfg = fused(cfg)
    hooked, _ = projections_per_pass(fcfg)
    if hooked != 4 * cfg.num_layers:
        raise AssertionError(f"{hooked} fused projections a pass")
    runs, out = {}, {"phase": "serve_fused", "arch": ARCH,
                     "bc_fused_per_pass": hooked}
    for bits in (None, 8, 4):
        tag = "float32" if bits is None else f"int{bits}"
        lane = {None: "bc_fused", 8: "bc_fused_i8", 4: "bc_fused_i4"}[bits]
        policy = (codec.QuantPolicy() if bits is None else
                  codec.QuantPolicy("int8", quant_weights=True,
                                    weight_bits=bits))
        results, reqs, st, launches, wall, peak = serve_run(fcfg, 16,
                                                            quant=policy)
        want = continuous_launches(fcfg, st, lane)
        if bits is not None:
            want["paged_attention_i8"] = want.pop("paged_attention")
        check_launches(launches, want)
        runs[f"continuous_{tag}"] = serve_summary(
            "serve_fused", fcfg, results, reqs, st, launches, wall, peak)
        reqs, results, st, launches, wall, peak = batch_run(fcfg, 16,
                                                            quant=policy)
        check_launches(launches, batch_launches(fcfg, st, lane,
                                                hooked=bits is None))
        runs[f"batch_{tag}"] = batch_summary(
            "serve_fused", fcfg, results, reqs, st, launches, wall, peak)
        sizes = {"fused": plane_bytes(fcfg, policy),
                 "unfused": plane_bytes(cfg, policy)}
        if sizes["fused"] != sizes["unfused"]:
            raise AssertionError(f"{tag} plane bytes {sizes}")
        runs[f"plane_bytes_{tag}"] = sizes["fused"]
    out.update(runs)
    out["parity"] = {arch: fused_parity(arch) for arch in FUSED_PARITY}
    out["phase_wall_s"] = time.perf_counter() - t0
    emit(out)
    return {"serve_fused": runs["continuous_float32"],
            "serve_fused_batch": runs["batch_float32"]}


# ---------------------------------------------------------------------------
# decode_graph: the continuous engine's step replayed against it eagerly
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# serve_obs: the telemetry plane on the card
# ---------------------------------------------------------------------------
OBS_ROUNDS = 4          # paired rounds of the three-arm overhead (cut
                        # from 8 for the script's time limit)


def obs_engine(cfg, params, obs, **kw):
    return ContinuousEngine(cfg, params, max_slots=8, max_seq=256,
                            page_size=16, decode_chunk=8, device=DEVICE,
                            quant=codec.QuantPolicy("int8",
                                                    quant_weights=True),
                            obs=obs, **kw)


def finite_snapshot(snap):
    """Every counter, gauge and histogram field of a snapshot finite."""
    vals = list(snap["counters"].values()) + list(snap["gauges"].values())
    for name, h in snap["histograms"].items():
        vals += [h["sum"]] + [h[k] for k in ("min", "max", "p50", "p99")
                              if h[k] is not None]
    return all(np.isfinite(v) for v in vals)


def phase_serve_obs(cfg):
    """tinyllama-1.1b at full width and depth through ``ContinuousEngine``
    with int8 planes and an int8 pool (so the quant telemetry runs), an
    ``Obs`` with a JSONL file, the stock SLO rules and a Chrome trace, and
    the shadow oracle replaying every finished request (``shadow_sample``
    1.0; 4 requests of 17-200 + 16 tokens: each replay decodes eagerly
    twice a step): the JSONL and the trace valid under the port's
    validators, the
    health histograms non-empty and finite, the shadow agreement, every
    dispatch kind's roofline fraction on the ``h100`` spec in (0, 1], and
    greedy tokens bit-equal with obs off.  Then the plane's cost as
    ``repro`` measures it (``obs_overhead``): tokens/s of three engines on
    the same weights (obs disabled, ``capture=False``, fully on; no
    emitter, no shadow) over 8 requests of 17-200 + 32 tokens in
    ``OBS_ROUNDS`` paired rounds, the arms' order
    rotated each round, the overheads the median per-round time ratios.
    Every engine captured its decode step once (the capture's warm-up
    runs with synchronizing calls made errors: no host read inside)."""
    params = init_params(cfg, seed=SEED, device=DEVICE)
    rng = np.random.RandomState(SEED)
    warm = make_requests(cfg, 2, 17, 40, 4, rng)
    reqs = make_requests(cfg, 8, 17, 200, 32, rng)
    shadowed = make_requests(cfg, 4, 17, 200, 16, rng)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        path, tpath = str(tmp / "m.jsonl"), str(tmp / "t.json")
        watchdog = SloWatchdog(default_rules())
        obs = Obs(emit_path=path, emit_every=4, slo=watchdog)
        eng = obs_engine(cfg, params, obs, shadow_sample=1.0)
        decode_graphs(eng.stats())
        for lib in LIBRARIES:
            lib.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.generate(shadowed)
        wall = time.perf_counter() - t0
        launches = lane_counts()
        st = eng.stats()
        eng.drain()                          # flush and close the emitter
        lines = validate_jsonl(path)
        if lines["trace"] != len(shadowed):
            raise AssertionError(f"serve_obs: {lines} for {len(shadowed)} "
                                 f"requests")
        trace = write_trace(obs, tpath, extra_meta={"arch": ARCH})
        with open(tpath) as f:
            validate_trace(json.load(f))
        lanes = {(ev.get("pid"), ev.get("tid"))
                 for ev in trace["traceEvents"]
                 if ev.get("cat") == "request" and ev.get("ph") == "X"}
        if len(lanes) < len(shadowed):
            raise AssertionError(f"serve_obs: {len(lanes)} request lanes")
        last = last_snapshot(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    hists = last["histograms"]
    health = {n: h["count"] for n, h in hists.items()
              if n.startswith("health.")}
    for name in ("health.logit_absmax{phase=prefill}",
                 "health.logit_absmax{phase=decode}",
                 "health.logit_entropy{phase=decode}",
                 "health.top1_margin{phase=decode}",
                 "health.act_absmax{phase=prefill}",
                 "health.shadow_agreement", "quant.k_scale"):
        if not hists.get(name, {}).get("count"):
            raise AssertionError(f"serve_obs: {name} is empty")
    if not finite_snapshot(last) or st["health"]["nonfinite_dispatches"]:
        raise AssertionError(f"serve_obs: a non-finite value, health "
                             f"{st['health']}")
    sh = st["shadow_oracle"]
    if sh["replays"] != len(shadowed) or sh["greedy_agreement"] is None:
        raise AssertionError(f"serve_obs: shadow oracle {sh}")
    roof = roofline_fractions("serve_obs", st)
    # obs off, a fresh engine as the obs-on one was: the same tokens
    off = obs_engine(cfg, params, Obs(enabled=False))
    toks = [r["tokens"] for r in off.generate(shadowed)]
    if toks != [r["tokens"] for r in results]:
        raise AssertionError("serve_obs: tokens differ with obs off")
    if any(r["status"] != "FINISHED_BUDGET" for r in results):
        raise AssertionError("serve_obs: a request did not finish")
    # the three-arm overhead, on three fresh engines
    del eng, off
    arms = {"disabled": obs_engine(cfg, params, Obs(enabled=False)),
            "no_capture": obs_engine(cfg, params, Obs(), capture=False),
            "enabled": obs_engine(cfg, params, Obs())}
    if (arms["enabled"]._health is None or arms["no_capture"]._health
            is not None or arms["disabled"]._health is not None):
        raise AssertionError("serve_obs: an arm's capture is not its own")
    for e in arms.values():
        decode_graphs(e.stats())
        e.generate(warm)
    # an int8 page recycled from an earlier request keeps its grown scale
    # (as in repro), so tokens are compared between arms at equal history:
    # each engine has its own pool and has served the same requests
    order, secs, tokens = list(arms), {a: [] for a in arms}, {}
    for r in range(OBS_ROUNDS):
        got = {}
        for arm in order[r % 3:] + order[:r % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = arms[arm].generate(reqs)
            torch.cuda.synchronize()
            secs[arm].append(time.perf_counter() - t0)
            tokens[arm] = sum(x["decode_len"] for x in res)
            got[arm] = [x["tokens"] for x in res]
        if got["enabled"] != got["disabled"] or got["no_capture"] != got[
                "disabled"]:
            raise AssertionError(f"serve_obs: round {r}: the arms' tokens "
                                 f"differ")
    ratio = statistics.median(e / d for e, d in zip(secs["enabled"],
                                                    secs["disabled"]))
    hratio = statistics.median(e / n for e, n in zip(secs["enabled"],
                                                     secs["no_capture"]))
    overhead = {arm: {"tokens_per_s_best": tokens[arm] / min(secs[arm]),
                      "tokens_per_s_median": tokens[arm]
                      / statistics.median(secs[arm]), "seconds": secs[arm]}
                for arm in arms}
    overhead.update(overhead_frac=ratio - 1.0,
                    health_capture_frac=hratio - 1.0, rounds=OBS_ROUNDS,
                    tokens=tokens["enabled"])
    out = {"phase": "serve_obs", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "requests": len(shadowed),
           "prompt_lens": [len(r.prompt) for r in shadowed],
           "overhead_prompt_lens": [len(r.prompt) for r in reqs],
           "tokens": sum(r["decode_len"] for r in results), "wall_s": wall,
           "quant_policy": st["quant_policy"], "hardware": st["hardware"],
           "jsonl_lines": lines, "trace_events": len(trace["traceEvents"]),
           "request_lanes": len(lanes), "slo_alerts": watchdog.stats(),
           "health": st["health"], "health_counts": health,
           "kv_clip_rate": st["kv_clip_rate"],
           "plane_clip_rate": last["gauges"]["quant.plane_clip_rate"],
           "scale_growths": st["scale_growths"],
           "requant_error_bound":
               last["counters"]["quant.requant_error_bound"],
           "shadow_oracle": sh, "tokens_equal_obs_off": True,
           "roofline": roof, "overhead": overhead,
           "launches": launches, **decode_graphs(st)}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# serve_chaos / serve_fleet: fault injection and the replicated fleet at
# tinyllama-1.1b's full width and depth (serve/faults.py, fleet/)
# ---------------------------------------------------------------------------
CHAOS_SEEDS = (0,)          # cut from 3 seeds for the time limit
CHAOS_REQUESTS, FLEET_REQUESTS = 24, 16
# the parity phases' near-tie rule (phase_parity): a greedy token may
# differ from the oracle's only where the oracle's top-2 logit gap is
# under 4 x the 1e-4 logit tolerance, of the logit scale
NEAR_TIE = 4e-4
# the fleet's hang replica: a step of the full-width model (its prefills
# and a 4-step decode dispatch) takes well under a second on the card, so
# its heartbeat bound is 1 s and the injected hang 1.25 s (repro's 3 and
# 4 ms are below a step at this width); the other replica keeps the
# default 5 s
FLEET_HANG = dict(hang_step_timeout_s=1.0, hang_s=1.25)


def reset_counts():
    """Every kernel's launch counts to 0 (the training kernel's too)."""
    for lib in TRAIN_LIBRARIES:
        lib.reset_counts()


def serving_lanes(launches, pool_lane):
    """Every projection through ``bc_fused``, the prefill through the flash
    kernel, the paged decode through ``pool_lane``: each launched while
    the engine served."""
    for lane in ("bc_fused", "flash_attention", pool_lane):
        if not launches.get(lane):
            raise AssertionError(f"no {lane} launch while serving: "
                                 f"{launches}")


def phase_serve_chaos(cfg, params):
    """``run_chaos``'s schedule (24 requests a seed: randomized prompts,
    budgets, deadlines, arrivals and cancels; ``FaultConfig`` allocator
    failures 0.05, dispatch delays 0.1 of 2 ms, corruption 0.08; 4 slots
    over a pool of half their full-grown footprint) at tinyllama-1.1b's
    full width and depth in float32, through ``ContinuousEngine`` on the
    card: ``CHAOS_SEEDS`` on an f32 pool, then the first on an int8 pool,
    where the poison lands in the K scales.  Each run holds invariants 1-4
    (the B=1 ``Engine`` on the card the oracle, under the near-tie rule;
    on the int8 pool the oracle part is that no poisoned request
    finishes), one decode-step capture, and the kernel lanes launched
    while serving (counts set to 0 after the oracle, before serving)."""
    runs = []
    for seed, kv in ([(s, "f32") for s in CHAOS_SEEDS]
                     + [(CHAOS_SEEDS[0], "int8")]):
        t0 = time.perf_counter()
        s = faults.run_chaos(ARCH, seed, requests=CHAOS_REQUESTS,
                             verbose=False, device=DEVICE, full=True,
                             params=params, quant=codec.QuantPolicy(kv),
                             near_tie=NEAR_TIE, on_serve=reset_counts)
        torch.cuda.synchronize()
        launches = lane_counts()
        serving_lanes(launches, "paged_attention_i8" if kv == "int8"
                      else "paged_attention")
        if s["decode_graphs"] != 1:
            raise AssertionError(f"serve_chaos seed {seed} {kv}: "
                                 f"{s['decode_graphs']} decode captures")
        if kv == "int8" and not (s["faults"]["corruptions"]
                                 and s["anomalies"]):
            raise AssertionError(f"serve_chaos int8: the guard did not trip "
                                 f"({s['faults']}, {s['anomalies']})")
        runs.append({
            "seed": seed, "kv_dtype": kv,
            "statuses": {k: n for k, n in s["statuses"].items() if n},
            "preemptions": s["preemptions"], "anomalies": s["anomalies"],
            "nonfinite_dispatches": s["health"]["nonfinite_dispatches"],
            "alerts": s["alerts"]["by_rule"], "faults": s["faults"],
            "oracle_parity": s["oracle_parity"],
            "near_ties": s["near_ties"], "decode_graphs": s["decode_graphs"],
            "pool_bytes": s["pool_bytes"], "events": s["events"],
            "steps": s["steps"], "tokens": s["tokens"],
            "serve_wall_s": s["wall_s"],
            "run_s": time.perf_counter() - t0, "launches": launches})
    out = {"phase": "serve_chaos", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": "float32",
           "requests": CHAOS_REQUESTS, "near_tie": NEAR_TIE, "runs": runs}
    emit(out)
    return out


def phase_serve_fleet(cfg, params):
    """``run_fleet_chaos``'s schedule at tinyllama-1.1b's full width and
    depth in float32: 2 replicas sharing one ``params`` on the card, 16
    requests, the victim's crash armed once it serves mid-flight and one
    request has settled, the other replica hanging now and then (3% of its
    steps, ``FLEET_HANG``).  The fleet invariants hold (every request
    settles once, none lost, the survivor's pool restored, migrated
    requests finish; the oracle parity under the near-tie rule), at least
    one migrated request finishes with the oracle's tokens outright, each
    replica's step timeouts are exactly its injected hangs, and each
    captured its decode step once."""
    t0 = time.perf_counter()
    s = faults.run_fleet_chaos(ARCH, seed=0, requests=FLEET_REQUESTS,
                               replicas=2, verbose=False, device=DEVICE,
                               full=True, params=params, near_tie=NEAR_TIE,
                               on_serve=reset_counts, **FLEET_HANG)
    torch.cuda.synchronize()
    launches = lane_counts()
    serving_lanes(launches, "paged_attention")
    rs = s["router"]
    for rep in rs["replicas"]:
        hangs = s["faults"][rep["name"]]["hangs"]
        if rep["step_timeouts"] != hangs:
            raise AssertionError(f"{rep['name']}: {rep['step_timeouts']} "
                                 f"step timeouts, {hangs} injected hangs")
        if rep["engine"]["decode_graphs"] != 1:
            raise AssertionError(f"{rep['name']}: "
                                 f"{rep['engine']['decode_graphs']} captures")
    exact = sorted(set(s["migrated_finished"])
                   - {t["id"] for t in s["near_ties"]})
    if not exact:
        raise AssertionError(f"no migrated request finished with the "
                             f"oracle's tokens: {s['near_ties']}")
    out = {"phase": "serve_fleet", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": "float32",
           "requests": s["requests"], "replicas": s["replicas"],
           "statuses": {k: n for k, n in s["statuses"].items() if n},
           "failovers": rs["failovers"],
           "migrated_requests": rs["migrated_requests"],
           "migrated": s["migrated"],
           "migrated_finished": s["migrated_finished"],
           "migrated_oracle_equal": exact, "near_ties": s["near_ties"],
           "hedges": rs["hedges"], "hedge_wins": rs["hedge_wins"],
           "shed": rs["shed"], "place_retries": rs["place_retries"],
           "replica_states": {r["name"]: r["state"] for r in rs["replicas"]},
           "down_reason": rs["replicas"][0]["down_reason"],
           "step_timeouts": {r["name"]: r["step_timeouts"]
                             for r in rs["replicas"]},
           "faults": s["faults"], **FLEET_HANG,
           "abandoned_pool_bytes": s["abandoned_pool_bytes"],
           "serve_wall_s": s["wall_s"], "tokens": s["tokens"],
           "tokens_per_s": s["tokens_per_s"],
           "run_s": time.perf_counter() - t0, "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# conv: the paper's block-circulant CONV layer (core/conv.py) on the card
# ---------------------------------------------------------------------------
# cifar_wrn's three 3x3 widths (benchmarks/common.py:158-162): channels in
# = out, feature maps; batch 128, SAME, stride 1; block 16, the block
# benchmarks/bench_compression.py:25 gives CONV layers
CONV_LAYERS = {"g1": (160, 32), "g2": (320, 16), "g3": (640, 8)}
CONV_BATCH, CONV_R, CONV_K = 128, 3, 16


def conv_layer_run(x, w, ct, C, path):
    """The layer forward and both gradients, (y, dx, dw), through
    ``conv2d_block_circulant`` on ``path`` ("fft": the kernels; "direct":
    plain PyTorch on the materialized W)."""
    xi = x.detach().requires_grad_(True)
    wi = w.detach().requires_grad_(True)
    y = conv.conv2d_block_circulant(xi, wi, CONV_R, C, padding="SAME",
                                    path=path)
    (y * ct).sum().backward()
    return y.detach(), xi.grad, wi.grad


def conv_library_run(x, w, ct, C):
    """The same three through ``F.conv2d`` (cuDNN, float32, TF32 off) on
    the filter materialized from ``w``, the generators' gradient through
    the materialization."""
    k, n_in = w.shape[-1], CONV_R * CONV_R * C
    xi = x.detach().requires_grad_(True)
    wi = w.detach().requires_grad_(True)
    p, q, _ = wi.shape
    f = cc.materialize_dense(wi, p * k, q * k)[:C, :n_in].T.reshape(
        CONV_R, CONV_R, C, C)
    y = conv.conv2d_dense(xi, f, padding="SAME")
    (y * ct).sum().backward()
    return y.detach(), xi.grad, wi.grad


def phase_conv(k=CONV_K):
    """The CONV layer at ``CONV_LAYERS``' shapes at block size ``k`` (the
    paper's 16, then ``repro``'s test block 4, whose kernels pad the DFT
    panel to 8; cases and groups named ``_k4``): the forward and both
    gradients on the kernel path (one ``bc_fused`` forward, one adjoint,
    one ``bc_grad_w`` a layer, counted at their shapes from 0) held
    against the plain path on the card and against ``F.conv2d`` on the
    materialized filter, each at 1e-4 of its scale, with the three paths'
    times (forward and backward) and the bound of the kernels' work; then
    each kernel at the layer's shape against its plain version on the same
    inputs, its call and device times, the plain version's, the library
    call computing the dense layer's same step (``F.conv2d``, its input
    gradient, its weight gradient: ``torch.nn.grad``), and its bound."""
    gen = kernel_gen()
    tag = "" if k == CONV_K else f"_k{k}"
    layers, fused_cases, grad_cases = [], [], []
    launches, shapes = {}, {}
    for name, (C, hw) in CONV_LAYERS.items():
        n_in = CONV_R * CONV_R * C
        p, q = cc.num_blocks(C, k), cc.num_blocks(n_in, k)
        N = CONV_BATCH * hw * hw
        w = conv.init_conv_circulant(CONV_R, C, C, k, generator=gen,
                                     device=DEVICE)
        x = torch.randn((CONV_BATCH, hw, hw, C), generator=gen,
                        device=DEVICE)
        ct = torch.randn((CONV_BATCH, hw, hw, C), generator=gen,
                         device=DEVICE)
        reset_counts()
        got = conv_layer_run(x, w, ct, C, "fft")
        torch.cuda.synchronize()
        run = lane_counts(TRAIN_LIBRARIES)
        run_shapes = shape_counts(TRAIN_LIBRARIES)
        want = {bc_fused.shape_key(1, N, p, q, k, "bc_fused"): 1,
                bc_fused.shape_key(1, N, q, p, k, "bc_fused"): 1}
        if (run_shapes.get("bc_fused") != want
                or run_shapes.get("bc_grad_w")
                != {bgw.shape_key(N, p, q, k): 1}
                or sum(run.values()) != 3):
            raise AssertionError(f"conv {name}: launches {run_shapes}")
        for lane, n in run.items():
            launches[lane] = launches.get(lane, 0) + n
        for lib, by in run_shapes.items():
            for key, n in by.items():
                shapes.setdefault(lib, {})[key] = n
        plain = conv_layer_run(x, w, ct, C, "direct")
        library = conv_library_run(x, w, ct, C)
        errs = {}
        for part, g, pl, lb in zip(("y", "dx", "dw"), got, plain, library):
            scale = max(1.0, float(pl.abs().max()))
            errs[part] = {"vs_plain": max_err(g, pl),
                          "vs_library": max_err(g, lb),
                          "plain_vs_library": max_err(pl, lb),
                          "tol": 1e-4 * scale}
            if not max(errs[part]["vs_plain"], errs[part]["vs_library"],
                       errs[part]["plain_vs_library"]) <= 1e-4 * scale:
                raise AssertionError(f"conv {name} {part}: {errs[part]}")
        # the kernels' inputs at this shape: the blocked patches, the
        # output gradient's blocks, the generators' planes
        xb = conv.im2col(x, CONV_R, padding="SAME").reshape(N, q, k)
        gy = ct.reshape(N, p, k).contiguous()
        planes = cc.spectral_cache(w)
        adj = kops.adjoint_planes(planes)
        xc = x.permute(0, 3, 1, 2).contiguous()
        ctc = ct.permute(0, 3, 1, 2).contiguous()
        fd = cc.materialize_dense(w, p * k, q * k)[:C, :n_in].T.reshape(
            CONV_R, CONV_R, C, C).permute(3, 2, 0, 1).contiguous()
        lib_ms = {
            "forward": time_ms(lambda: F.conv2d(xc, fd, padding=1), **LONG),
            "adjoint": time_ms(lambda: torch.nn.grad.conv2d_input(
                xc.shape, fd, ctc, padding=1), **LONG),
            "grad_w": time_ms(lambda: torch.nn.grad.conv2d_weight(
                xc, fd.shape, ctc, padding=1), **LONG)}
        works = {}
        for case, (inp, pl, pq) in (
                ("forward", (xb, planes, (p, q))),
                ("adjoint", (gy, adj, (q, p)))):
            a = (inp, pl["wr"], pl["ws1"], pl["ws2"], k)
            out = bc_fused.bc_fused_matmul(*a)
            ref = bc_fused.bc_fused_matmul_plain(*a)
            nbytes, flops = fused_work(N, *pq, k)
            works[case] = (nbytes, flops)
            bound_ms, bound_by = bound(nbytes, flops, torch.float32)
            fused_cases.append({
                "case": f"conv_{name}{tag}_{case}", "shape": [N, *pq, k],
                "launch_shape": bc_fused.shape_key(1, N, *pq, k, "bc_fused"),
                "plan": bc_fused.plan(N, *pq, k, "bc_fused")._asdict(),
                "max_abs_err": max_err(out, ref),
                "tol": 1e-4 * max(1.0, float(ref.abs().max())),
                **kernel_times(lambda: bc_fused.bc_fused_matmul(*a), **LONG),
                "plain_ms": time_ms(lambda: bc_fused.bc_fused_matmul_plain(
                    *a), **LONG),
                "library_ms": lib_ms[case],
                "library": ("F.conv2d, the dense layer's forward (cuDNN, "
                            "float32)" if case == "forward" else
                            "torch.nn.grad.conv2d_input, the dense layer's "
                            "input gradient"),
                "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms, "bound_by": bound_by})
        out = bgw.bc_grad_w(gy, xb, k)
        ref = bgw.bc_grad_w_plain(gy, xb, k)
        nbytes, flops = grad_w_work(1, N, p, q, k)
        works["grad_w"] = (nbytes, flops)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        grad_cases.append({
            "case": f"conv_{name}{tag}", "shape": [N, p, q, k],
            "launch_shape": bgw.shape_key(N, p, q, k),
            "plan": bgw.plan(N, p, q, k)._asdict(),
            "max_abs_err": max_err(out, ref),
            "tol": 1e-4 * max(1.0, float(ref.abs().max())),
            **kernel_times(lambda: bgw.bc_grad_w(gy, xb, k), **LONG),
            "plain_ms": time_ms(lambda: bgw.bc_grad_w_plain(gy, xb, k),
                                **LONG),
            "library_ms": lib_ms["grad_w"],
            "library": "torch.nn.grad.conv2d_weight, the dense layer's "
                       "weight gradient (the dense filter's, not the "
                       "generators')",
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by})
        for c in fused_cases[-2:] + grad_cases[-1:]:
            c["bound_share"] = (c["bound_ms"] / c["device_ms"]
                                if c["device_ms"] else None)
            if not c["max_abs_err"] <= c["tol"]:
                raise AssertionError(f"conv {c['case']}: {c['max_abs_err']}"
                                     f" > {c['tol']}")
        layer_bytes = sum(b for b, _ in works.values())
        layer_flops = sum(f for _, f in works.values())
        bound_ms, bound_by = bound(layer_bytes, layer_flops, torch.float32)
        layers.append({
            "layer": name, "channels": C, "maps": [hw, hw],
            "batch": CONV_BATCH, "rows": N, "blocks": [p, q, k],
            "errors": errs, "launches": run, "launch_shapes": run_shapes,
            "kernel_ms": time_ms(lambda: conv_layer_run(
                x, w, ct, C, "fft"), **LONG),
            "plain_ms": time_ms(lambda: conv_layer_run(
                x, w, ct, C, "direct"), **LONG),
            "library_ms": time_ms(lambda: conv_library_run(x, w, ct, C),
                                  **LONG),
            "library_conv_only_ms": sum(lib_ms.values()),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del x, ct, xb, gy, xc, ctc, got, plain, library
        torch.cuda.empty_cache()
    out = {"phase": "conv", "block": k, "kernel": [CONV_R, CONV_R],
           "layers": layers, "launches": launches, "shapes": shapes,
           "kernel_cases": {"bc_fused": fused_cases,
                            "bc_grad_w": grad_cases}}
    emit(out)
    return {"launches": launches, "shapes": shapes,
            "kernels": {f"conv_bc_fused{tag}": (fused_cases,
                                                f"conv_g2{tag}_forward"),
                        f"conv_bc_grad_w{tag}": (grad_cases,
                                                 f"conv_g2{tag}")}}


# ---------------------------------------------------------------------------
# block_sizes, serve_kvf8, dist: the block sizes, the float8 dense cache and
# the distribution layer that repro takes
# ---------------------------------------------------------------------------


def block_cfg(cfg, k):
    """``cfg`` with every attention and FFN projection at block size k.
    At k <= 8 ``repro``'s auto path materializes the blocks (a dense
    product, ``direct``); the path is set to ``spectral`` there (its own
    override: baked planes to serve, the FFT backward to train), so the
    circulant kernels carry it."""
    return cfg.with_compression(block_ffn=k, block_attn=k,
                                **({"path": "spectral"} if k <= 8 else {}))


def block_kernel_checks(cfg, gen):
    """At ``cfg``'s block size k: ``bc_fused`` at tinyllama's up/gate on
    every plane lane at B = 8 (the continuous step's rows) and on the
    float32 lane at the training rows, and ``bc_grad_w`` at the training
    rows, each against its plain version, in groups named ``<lane>_k<k>``
    (their library: the dense product / the complex64 contraction)."""
    k = cfg.compression.block_attn
    up = {f"k{k}_up_gate": (cfg.d_model, cfg.d_ff)}
    train_up = {f"k{k}_train_up_gate": (cfg.d_model, cfg.d_ff)}
    out = {f"{lane}_k{k}": (cases, f"k{k}_up_gate_b8")
           for lane, (cases, _) in check_bc_fused(cfg, gen, up,
                                                  batches=(8,)).items()}
    out[f"bc_fused_k{k}"][0].extend(check_bc_fused(
        cfg, gen, train_up, batches=(BLOCK_ROWS,), lane_names=("bc_fused",),
        timing=LONG)["bc_fused"][0])
    cases, main = check_bc_grad_w(cfg, gen, N=BLOCK_ROWS, shapes=up)[
        "bc_grad_w"]
    out[f"bc_grad_w_k{k}"] = (cases, main)
    if k == 256:             # the batch prefill's MAC at F = 129 bins
        out["spectral_matmul_k256"] = (check_spectral(
            cfg, gen, [(f"k{k}_up_gate", cfg.d_model, cfg.d_ff, k)])[
                "spectral_matmul"][0], f"k{k}_up_gate_n{ROWS}_hook")
    return out


def block_serve(cfg, k):
    """The serving half of ``phase_block_sizes`` at block size k: the
    continuous engine and the batch engine on fresh random weights with
    exact launch counts, then the B=1 oracle."""
    s = BLOCK_SERVE
    L = cfg.num_layers
    params = init_params(cfg, seed=SEED, device=DEVICE)
    rng = np.random.RandomState(SEED + k)
    reqs = make_requests(cfg, s["n"], s["lo"], s["hi"], s["new"], rng)
    out, runs = {}, {}
    engine = ContinuousEngine(cfg, params, max_slots=8, max_seq=s["max_seq"],
                              page_size=16, decode_chunk=8, device=DEVICE)
    results, st, launches, wall, peak = timed_run(engine, reqs)
    check_launches(launches, {
        "bc_fused": 7 * L * (st["prefills"] + st["decode_steps"]),
        "flash_attention": L * st["prefills"],
        "paged_attention": L * st["decode_steps"]})
    out["continuous"] = {**serve_summary("block_sizes", cfg, results, reqs,
                                         st, launches, wall, peak),
                         "shapes": shape_counts()}
    runs["continuous"] = {"launches": launches, "shapes": shape_counts()}
    del engine
    # the batch engine's prefill MAC: spectral_matmul plans every plane
    # shape at 256 (F = 129 bins), none at 4, so the fused kernel takes
    # them there
    engine = Engine(cfg, params, max_batch=8, max_seq=s["max_seq"],
                    device=DEVICE)
    hooked = k == 256
    lanes = engine.stats()["prefill_lanes"]
    if bool(lanes["bc_fused"]) == hooked or \
            bool(lanes["spectral_matmul"]) != hooked:
        raise AssertionError(f"block size {k}: prefill lanes {lanes}")
    results, st, launches, wall, peak = timed_run(engine, reqs)
    check_launches(launches, batch_launches(cfg, st, hooked=hooked))
    out["batch"] = {**batch_summary("block_sizes", cfg, results, reqs, st,
                                    launches, wall, peak),
                    "prefill_lanes": lanes}
    runs["batch"] = {"launches": launches}
    del engine
    del params
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    params32 = precompute_serving_params(
        init_params(cfg32, seed=SEED + 1, device=DEVICE), cfg32)
    prompt = np.random.RandomState(SEED + k + 1).randint(
        0, cfg.vocab_size, size=s["oracle_len"]).astype(np.int32)
    _, out["oracle"] = oracle_check(cfg32, params32, prompt, s["oracle_new"])
    del params32
    torch.cuda.empty_cache()
    return out, runs


def block_train(cfg, k):
    """The training half: ``BLOCK_TRAIN`` through the launcher with
    ``--block-size k``: losses finite, no step skipped, and the launches a
    step by shape equal to those the model calls for."""
    t = BLOCK_TRAIN
    res, wall, peak = launch_train_run(
        ["--arch", ARCH, "--full", "--block-size", str(k),
         "--path", cfg.compression.path, "--steps", str(t["steps"]),
         "--ckpt-every", "0"], batch=t["batch"], seq=t["seq"])
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    if (len(hist) != t["steps"] or not all(np.isfinite(losses))
            or int(res["state"]["skipped"])):
        raise AssertionError(f"block size {k}: losses {losses}, skipped "
                             f"{int(res['state']['skipped'])}")
    want_fused, want_grads = train_shape_counts(cfg, BLOCK_ROWS)
    shapes = shape_counts(TRAIN_LIBRARIES)
    got = ({s_: n / t["steps"] for s_, n in shapes.get("bc_fused",
                                                       {}).items()},
           {s_: n / t["steps"] for s_, n in shapes.get("bc_grad_w",
                                                       {}).items()})
    if got != (want_fused, want_grads):
        raise AssertionError(f"block size {k}: launches a step {got}, "
                             f"expected {(want_fused, want_grads)}")
    launches = lane_counts(TRAIN_LIBRARIES)
    check_launches(launches, {
        "bc_fused": t["steps"] * sum(want_fused.values()),
        "bc_grad_w": t["steps"] * sum(want_grads.values())})
    ms, ms_step = train_steps_summary(hist, first=1)
    summary = {"batch": t["batch"], "seq": t["seq"], "steps": t["steps"],
               "losses": losses, "step_ms": ms, "ms_per_step": ms_step,
               "tokens_per_s": 1e3 * BLOCK_ROWS / ms_step, "wall_s": wall,
               "peak_memory_bytes": peak, "launches": launches,
               "params": sum(p.numel()
                             for p in res["state"]["model"].parameters())}
    return summary, {"launches": launches, "shapes": shapes}


def phase_block_sizes(cfg):
    """tinyllama-1.1b at full width and depth with every projection at
    block size 256 (DFT panel read from memory: 264 KB is past a block's
    shared memory) and 4 (the panel padded to the tensor cores' 8; path
    ``spectral``, ``block_cfg``): at 256
    the continuous and batch engines (the batch prefill's MAC through
    ``spectral_matmul`` at F = 129), the B=1 oracle and 3 training steps;
    at 4 (p = q = 512 at q/o, kf = 3) the continuous engine, the oracle and
    3 training steps.  Exact launch counts; the kernels at these k against
    their plain versions (``block_kernel_checks``)."""
    gen = kernel_gen()
    kernels, runs = {}, {}
    for k in BLOCK_SIZES:
        t0 = time.perf_counter()
        kcfg = block_cfg(cfg, k)
        record_kernels(kernels, block_kernel_checks(kcfg, gen))
        serve, serve_runs = block_serve(kcfg, k)
        train, train_run = block_train(kcfg, k)
        for name, run in serve_runs.items():
            runs[f"block_sizes/k{k}/{name}"] = run
        runs[f"block_sizes/k{k}/train"] = train_run
        a = kcfg.attention
        emit({"phase": "block_sizes", "block": k, "arch": ARCH,
              "layers": kcfg.num_layers, "d_model": kcfg.d_model,
              "blocks": {name: [cc.num_blocks(o, k), cc.num_blocks(i, k)]
                         for name, (i, o) in projections(kcfg).items()},
              "panel_staged": bc_fused.panel_staged(k),
              "heads": [a.num_heads, a.num_kv_heads, a.head_dim],
              **serve, "train": train, "wall_s": time.perf_counter() - t0})
    return kernels, runs


# ---------------------------------------------------------------------------
# nogauss: the paper's 4-product MAC (gauss_trick=False) on the main path
# ---------------------------------------------------------------------------
def nogauss_train(cfg):
    """``NOGAUSS_TRAIN``'s steps of ``cfg`` (bf16, remat) through the train
    step on the card, weights from the seed: losses finite, none skipped,
    every projection's forward (twice under remat) and adjoint on the
    4-product lane, its weight gradient through ``bc_grad_w``
    (``train_expected``), no other kernel."""
    t = NOGAUSS_TRAIN
    model = init_params(cfg, seed=SEED, device=DEVICE)
    opt = adamw.AdamWConfig()
    state = ts.init_state(cfg, opt, model=model)
    step = ts.make_train_step(cfg, opt)
    data = SyntheticLM(cfg, batch=t["batch"], seq=t["seq"], seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for lib in TRAIN_LIBRARIES:
        lib.reset_counts()
    losses, ms = [], []
    for i in range(t["steps"]):
        batch = {k: v.to(DEVICE) for k, v in data(i).items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    launches = lane_counts(TRAIN_LIBRARIES)
    if not all(np.isfinite(losses)) or int(state["skipped"]):
        raise AssertionError(f"nogauss train: losses {losses}, skipped "
                             f"{int(state['skipped'])}")
    want, _ = train_expected(cfg, model)
    check_launches(launches, {"bc_fused4": t["steps"] * want["bc_fused"],
                              "bc_grad_w": t["steps"] * want["bc_grad_w"]})
    out = {"batch": t["batch"], "seq": t["seq"], "steps": t["steps"],
           "losses": losses, "step_ms": ms, "launches": launches,
           "bc_fused4_per_step": want["bc_fused"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del state, model
    torch.cuda.empty_cache()
    return out, {"launches": launches}


def phase_nogauss(cfg):
    """tinyllama-1.1b at full width and depth with ``gauss_trick=False``
    (repro's hillclimb variant ``nogauss``: the paper's own MAC): every
    projection on ``bc_fused``'s 4-product lanes.  ``NOGAUSS``'s requests
    through the continuous engine and the batch engine (its prefill MAC
    too: ``spectral_matmul`` contracts the Gauss planes only, as
    ``prefill_lanes`` and their reasons say), then through the continuous
    engine on int8 and int4 planes (an int8 pool), each with exact launch
    counts and no other projection lane; one float32 request against the
    CPU's plain path (``card_cpu_parity``); and ``NOGAUSS_TRAIN``'s training
    steps (``nogauss_train``)."""
    t0 = time.perf_counter()
    ncfg = cfg.with_compression(gauss_trick=False)
    s, L = NOGAUSS, ncfg.num_layers
    rng = np.random.RandomState(SEED + 5)
    reqs = make_requests(ncfg, s["n"], s["lo"], s["hi"], s["new"], rng)
    out, runs = {}, {}
    params = init_params(ncfg, seed=SEED, device=DEVICE)
    engine = ContinuousEngine(ncfg, params, max_slots=8,
                              max_seq=s["max_seq"], page_size=16,
                              decode_chunk=8, device=DEVICE)
    results, st, launches, wall, peak = timed_run(engine, reqs)
    check_launches(launches, continuous_launches(ncfg, st,
                                                 lane="bc_fused4"))
    out["continuous"] = serve_summary("nogauss", ncfg, results, reqs, st,
                                      launches, wall, peak)
    runs["nogauss"] = {"launches": launches}
    del engine
    engine = Engine(ncfg, params, max_batch=8, max_seq=s["max_seq"],
                    device=DEVICE)
    lanes = engine.stats()["prefill_lanes"]
    reasons = engine._contract.reasons
    if lanes["spectral_matmul"] or not lanes["bc_fused"] or not all(
            "gauss_trick=False" in r for r in reasons.values()):
        raise AssertionError(f"nogauss: prefill lanes {lanes} {reasons}")
    results, st, launches, wall, peak = timed_run(engine, reqs)
    check_launches(launches, batch_launches(ncfg, st, lane="bc_fused4",
                                            hooked=False))
    out["batch"] = {**batch_summary("nogauss", ncfg, results, reqs, st,
                                    launches, wall, peak),
                    "prefill_lanes": lanes,
                    "prefill_reason": sorted(set(reasons.values()))}
    runs["nogauss/batch"] = {"launches": launches}
    del engine, params
    torch.cuda.empty_cache()
    for bits in (8, 4):
        policy = codec.QuantPolicy("int8", quant_weights=True,
                                   weight_bits=bits)
        params = init_params(ncfg, seed=SEED, device=DEVICE)
        engine = ContinuousEngine(ncfg, params, max_slots=8,
                                  max_seq=s["max_seq"], page_size=16,
                                  decode_chunk=8, device=DEVICE,
                                  quant=policy)
        results, st, launches, wall, peak = timed_run(engine, reqs)
        lane = bc_fused.LANES4[torch.int8 if bits == 8 else torch.uint8]
        check_launches(launches, {
            lane: 7 * L * (st["prefills"] + st["decode_steps"]),
            "flash_attention": L * st["prefills"],
            "paged_attention_i8": L * st["decode_steps"]})
        out[f"continuous_int{bits}"] = serve_summary(
            "nogauss", ncfg, results, reqs, st, launches, wall, peak)
        runs[f"nogauss_int{bits}"] = {"launches": launches}
        del engine, params
        torch.cuda.empty_cache()
    out["parity"] = card_cpu_parity(ncfg, SEED + 7)
    out["train"], runs["nogauss/train"] = nogauss_train(ncfg)
    emit({"phase": "nogauss", "arch": ARCH, "layers": L,
          "d_model": ncfg.d_model, "gauss_trick": False, **out,
          "wall_s": time.perf_counter() - t0})
    return runs


# ---------------------------------------------------------------------------
# dryrun: the dry run's records, and its prediction held against the card
# ---------------------------------------------------------------------------
def start_dryruns():
    """Start ``DRYRUN_JOBS`` as subprocesses of ``repro_torch.launch.
    dryrun`` at once (each its own fake process group, one CPU thread, the
    card hidden from them), each writing its records to a temporary
    directory.  Returns (directory, [(process, records path, log path)],
    start time) for ``finish_dryruns``; should the script stop before it,
    they are killed at exit."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = []
    for i, (arch, shape, mesh, extra) in enumerate(DRYRUN_JOBS):
        out, log = tmp / f"dryrun_{i}.json", tmp / f"dryrun_{i}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
                 *extra],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT),
                out, log))
    atexit.register(stop_dryruns, tmp, procs)
    return tmp, procs, time.perf_counter()


def stop_dryruns(tmp, procs):
    """Kill what is left of the dry-run jobs and remove their directory."""
    for p, _, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def finish_dryruns(started):
    """Wait for ``start_dryruns``'s jobs within ``DRYRUN_TIMEOUT`` s of
    their start (killing what is left), remove their directory, and
    return each job's (exit code, records, log tail) and the seconds from
    their start to the last one's end."""
    tmp, procs, t0 = started
    done = []
    try:
        for p, out, log in procs:
            rc = p.wait(timeout=max(1.0, t0 + DRYRUN_TIMEOUT
                                    - time.perf_counter()))
            recs = json.loads(out.read_text()) if out.exists() else []
            done.append((rc, recs, log.read_text()[-1500:]))
        return done, time.perf_counter() - t0
    finally:
        stop_dryruns(tmp, procs)


def measured_step(step, args):
    """``step(*args)`` with every launch count set to 0 and the peak
    memory reset just before: (rise of ``max_memory_allocated`` over the
    allocated bytes before it, launch counts, seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for lib in TRAIN_LIBRARIES:
        lib.reset_counts()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - base
    del out
    return rise, standin.launch_counts(), seconds


def hold_record(rec, inputs, rise, launches, what):
    """The three checks of a one-rank record against the card: argument
    bytes equal to the step's inputs, new bytes (temp plus the outputs
    that are not inputs) within ``DRYRUN_PEAK_TOL`` of the rise, and the
    launches per lane, path and shape equal (where ``launches`` is
    given).  Returns the comparison."""
    mem = rec["memory"]
    predicted = (mem["temp_bytes"] + mem["output_bytes"]
                 - mem["alias_bytes"])
    tol = DRYRUN_PEAK_TOL["rel"] * predicted + DRYRUN_PEAK_TOL["abs"]
    if mem["argument_bytes"] != inputs:
        raise AssertionError(f"dryrun {what}: argument bytes "
                             f"{mem['argument_bytes']} predicted, {inputs} "
                             f"on the card")
    if not abs(rise - predicted) <= tol:
        raise AssertionError(f"dryrun {what}: {predicted} new bytes "
                             f"predicted, {rise} measured (tolerance {tol})")
    if launches is not None and launches != rec["launches"]:
        raise AssertionError(f"dryrun {what}: launches {rec['launches']} "
                             f"traced, {launches} on the card")
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "reduced": rec.get("reduced"),
            "argument_bytes": mem["argument_bytes"],
            "input_bytes_on_card": inputs, "predicted_new_bytes": predicted,
            "measured_rise_bytes": rise, "diff_bytes": rise - predicted,
            "tol_bytes": tol, "launches_equal": launches is not None,
            "launches": rec["launches"]}


def dryrun_card_check(rec):
    """The one-rank dry run of recurrentgemma-2b x long_500k (a decode step
    of one row at position 524,287) against the same step on the card at
    full width and depth, baked planes, through ``bc_fused`` and the flash
    rows kernel (``launch/dryrun.py:card_cell``), held to the record by
    ``hold_record``: argument bytes, new bytes, and the launches per lane,
    path and shape (one flash launch an attention layer).  Each attention
    layer's ring is filled in position order first, as the trace takes it
    (18 of 26 layers are RG-LRU blocks: their state is the cache)."""
    cfg = get_config(RGEMMA)
    S = 524288
    step, (params, tokens, cache), real = dryrun_lib.card_cell(
        RGEMMA, "long_500k", device=DEVICE, seed=SEED)
    for c in cache:
        if isinstance(c, dict):
            n = c["pos"].shape[0]
            slots = torch.arange(n, dtype=torch.int64)
            c["pos"].copy_((S - 2) - ((S - 2 - slots) % n))
    for i in range(2):                     # warm-up, then the measured one
        rise, launches, _ = measured_step(step, (params, tokens, cache))
    kinds = layer_kinds(cfg)
    n_attn = sum(k in tfm.ATTN_KINDS for k in kinds)
    lanes = {k: v["lanes"] for k, v in launches.items()}
    if not (lanes.get("bc_fused") and lanes["flash_attention"]
            == {"flash_attention": n_attn}):
        raise AssertionError(f"dryrun: the card's step launched {launches}")
    out = hold_record(rec, real, rise, launches, "recurrentgemma-2b "
                      "long_500k")
    del params, cache, step
    torch.cuda.empty_cache()
    return out


def dryrun_one_check(rec):
    """A one-rank tinyllama-1.1b record (``DRYRUN_ONE``'s prefill_32k
    through the batch engine's prefill with its ``PrefillContract``, or
    one train_4k step: ``bc_fused`` forward and adjoint, ``bc_grad_w``, the
    plain ``masked_attention``) against the same step on the card at full
    width and depth, the record's batch (``launch/dryrun.py:card_cell``):
    a warm-up, then the measured step; argument bytes, new bytes and the
    launches per lane, path and shape held to the record
    (``hold_record``)."""
    kw = DRYRUN_ONE[rec["shape"]]
    step, args, inputs = dryrun_lib.card_cell(
        ARCH, rec["shape"], accum=kw["accum"], global_batch=kw["batch"],
        device=DEVICE, seed=SEED)
    times = []
    for i in range(2):                     # warm-up, then the measured one
        rise, launches, seconds = measured_step(step, args)
        times.append(seconds)
    out = hold_record(rec, inputs, rise, launches,
                      f"{ARCH} {rec['shape']}")
    out["step_s"] = times
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dryrun(started):
    """``repro_torch.launch.dryrun`` in subprocesses (``DRYRUN_JOBS``,
    started by ``start_dryruns`` after the last phase that times anything,
    so that no timing shares the host's cores with the traces):
    tinyllama-1.1b x every shape on both production meshes, llama4 x
    decode_32k, recurrentgemma-2b and xlstm-125m x long_500k on the
    single-pod one; every cell ``ok`` but tinyllama's long_500k (skipped
    with repro's reason); each record's status, bytes a device against
    this card's memory, FLOPs, collective bytes and dominant term on the
    ``h100`` spec (predictions: nothing runs on the card).  Then the
    one-rank record against the card (``dryrun_card_check``)."""
    t0 = time.perf_counter()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    jobs, trace_s = finish_dryruns(started)
    records, ones = [], {}
    for rc, recs, log in jobs:
        if rc != 0 or not recs:
            raise AssertionError(f"dryrun: exit {rc}, {len(recs)} records; "
                                 f"{log}")
        for r in recs:
            skip_ok = (r["status"] == "skipped" and r["shape"] == "long_500k"
                       and r["arch"] == ARCH)
            if r["status"] != "ok" and not skip_ok:
                raise AssertionError(f"dryrun: {r['arch']} x {r['shape']} "
                                     f"on {r['mesh']}: {r['status']} "
                                     f"{r.get('error') or r.get('why')}")
            if r["mesh"] == "1x1":
                ones[r["arch"], r["shape"]] = r
                continue
            records.append({
                "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "status": r["status"], "why": r.get("why"),
                **({} if r["status"] != "ok" else {
                    "bytes_per_device": r["bytes_per_device"],
                    "share_of_card": r["bytes_per_device"] / card_bytes,
                    "fits_card": r["bytes_per_device"] <= card_bytes,
                    "argument_bytes": r["memory"]["argument_bytes"],
                    "temp_bytes": r["memory"]["temp_bytes"],
                    "flops_per_device": r["flops_per_device"],
                    "collective_bytes": r["collectives"]["total"],
                    "collectives": r["collectives"],
                    "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                    "collective_s": r["collective_s"],
                    "dominant": r["dominant"], "launches": r["launches"],
                    "prefill_lanes": r.get("prefill_lanes"),
                    "trace_s": r["wall_s"]})})
    checks, failed = [], []
    for check, key in ([(dryrun_card_check, (RGEMMA, "long_500k"))]
                       + [(dryrun_one_check, (ARCH, shape))
                          for shape in DRYRUN_ONE]):
        try:
            checks.append(check(ones[key]))
        except AssertionError as e:     # every check runs; then it fails
            failed.append(str(e))
            checks.append({"arch": key[0], "shape": key[1],
                           "failed": str(e)})
    emit({"phase": "dryrun", "card_memory_bytes": card_bytes,
          "hardware": "h100", "records": records, "card_checks": checks,
          "jobs": len(jobs), "traces_wall_s": trace_s,
          "wall_s": time.perf_counter() - t0})
    if failed:
        raise AssertionError("; ".join(failed))


def check_flash_e4m3(gen, name, B, Hq, Hkv, Sq, Skv, D, **kw):
    """The flash kernel's e4m3 lane (the rows kernel at any rows): a
    float32 query over K/V stored as float8_e4m3fn (as ``layers/
    attention.py:to_cache`` writes a cache),
    against ``attention_ref`` on K/V widened to float32.  Bytes count K/V
    at 1 byte.  No library call reads an e4m3 cache (SDPA takes q, k and
    v of one dtype): ``library_ms`` None."""
    q = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda")
    k, v = (attn_lib.to_cache(torch.randn((B, Hkv, Skv, D), generator=gen,
                                          device="cuda"),
                              torch.float8_e4m3fn) for _ in range(2))
    got = fa.flash_attention(q, k, v, **kw)
    ref = fa.attention_ref(q, k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    causal, off = kw.get("causal", True), kw.get("kv_offset", 0)
    w = fa.work(B, Hq, Hkv, Sq, Skv, D, torch.float32, torch.float8_e4m3fn,
                causal=causal, kv_offset=off)
    nbytes, flops = w.nbytes, w.flops
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    pl = fa.plan(B, Hq, Hkv, Sq, Skv, D, torch.float32, torch.float8_e4m3fn)
    return {"case": name, "shape": [B, Hq, Hkv, Sq, Skv, D],
            "path": pl.path + "_e4m3", "kv_dtype": "float8_e4m3fn",
            "launch_shape": fa.shape_key(
                B, Hq, Hkv, Sq, Skv, D, torch.float32, causal=causal,
                kv_offset=off, kv_dtype=torch.float8_e4m3fn),
            "plan": {**pl._asdict(), "dtype": "float32"},
            "max_abs_err": max_err(got, ref),
            "tol": 1e-4 * max(1.0, float(ref.abs().max())),
            **kernel_times(lambda: fa.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: fa.attention_ref(
                q, k.float(), v.float(), **kw)),
            "library_ms": None,
            "library": "none: no PyTorch call reads an e4m3 K/V under a "
                       "float32 query",
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_serve_kvf8(cfg):
    """tinyllama-1.1b at full width and depth in float32 through the batch
    ``Engine`` with ``kv_cache_dtype="float8_e4m3fn"``'s dense cache
    (``cache_dtype``): ``KVF8``'s B requests of one length, the prefill on
    the float32 tensor-core flash over the fresh K/V (as ``repro``'s
    prefill reads them), every decode step's attention on the e4m3 rows
    lane (exact launch counts by path), the cache a quarter of float32's.
    The engine's tokens equal its path's by hand (``batch_traces``) and a
    B=1 engine's its B=1 path's; each row of the batch against the B=1
    oracle over the same float8 cache step by step (tokens up to the
    first near-tie; a K/V value within float32 noise of an e4m3 rounding
    midpoint takes the neighbouring code in the two, so step logits are
    held at ``KVF8_TOL`` of the scale), and the float8 oracle against the
    float32 and bfloat16 caches' (the controls: each must exceed the
    limit)."""
    t0 = time.perf_counter()
    f8 = torch.float8_e4m3fn
    cfg32 = cfg.replace(dtype="float32", kv_cache_dtype="float8_e4m3fn")
    L, B, S, new = cfg32.num_layers, KVF8["B"], KVF8["S"], KVF8["new"]
    params = precompute_serving_params(
        init_params(cfg32, seed=SEED + 5, device=DEVICE), cfg32)
    rng = np.random.RandomState(SEED + 5)
    prompts = rng.randint(0, cfg32.vocab_size, size=(B, S)).astype(np.int32)
    reqs = [Request(prompt=p, max_new_tokens=new, id=i)
            for i, p in enumerate(prompts)]
    engine = Engine(cfg32, params, max_batch=B, max_seq=S + new,
                    device=DEVICE, cache_dtype=f8)
    results, st, launches, wall, peak = timed_run(engine, reqs)
    paths = path_counts()
    want_paths = {"f32_mma": L * st["prefills"],
                  "f32_rows_e4m3": L * st["decode_steps"]}
    check_launches(launches, batch_launches(cfg32, st))
    if paths.get("flash_attention") != want_paths or st["cache_dtype"] \
            != "float8_e4m3fn":
        raise AssertionError(f"serve_kvf8: flash paths {paths}, expected "
                             f"{want_paths}; cache {st['cache_dtype']}")
    batched = batch_traces(cfg32, params, prompts, new, f8)
    if [r["tokens"] for r in results] != [t for t, _ in batched]:
        raise AssertionError("serve_kvf8: the engine's tokens are not its "
                             "path's")
    one = generate_one(Engine(cfg32, params, max_batch=1, max_seq=S + new,
                              device=DEVICE, cache_dtype=f8), prompts[0],
                       new)
    oracles = [batch_trace(cfg32, params, p, new, f8) for p in prompts]
    if one != oracles[0][0]:
        raise AssertionError(f"serve_kvf8: B=1 engine {one} against its "
                             f"path {oracles[0][0]}")
    scale = max(1.0, float(oracles[0][1][0].abs().max()))
    rows = [compare_traces(b, o, KVF8_TOL * scale)
            for b, o in zip(batched, oracles)]
    # the controls: the float8 oracle against the same request over a
    # float32 and a bfloat16-rounded cache, up to their first differing
    # token; a batch row that read a wider cache than e4m3 would be off by
    # as much, so the limit must sit below both
    controls = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ref = batch_trace(cfg32, params, prompts[0], new, dt)
        n = next((i for i, (a, b) in enumerate(zip(ref[0], oracles[0][0]))
                  if a != b), len(ref[0]))
        controls[name] = {"tokens_equal": n, "max_step_err_before": max_err(
            ref[1][:max(n, 1)], oracles[0][1][:max(n, 1)]) / scale,
            "tokens": ref[0]}
    if not all(c["max_step_err_before"] > KVF8_TOL for c in controls.values()):
        raise AssertionError(f"serve_kvf8: the limit {KVF8_TOL} of the "
                             f"logit scale does not separate the wider "
                             f"caches' {controls}")
    vs_f32 = {**controls, "tokens_f8": oracles[0][0]}
    tokens = sum(r["decode_len"] for r in results)
    out = {"phase": "serve_kvf8", "arch": ARCH, "layers": L,
           "d_model": cfg32.d_model, "dtype": "float32",
           "cache_dtype": "float8_e4m3fn", "requests": B, "prompt_len": S,
           "new_tokens": new, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "prefill_s": st["prefill_s"],
           "decode_s": st["decode_s"], "decode_steps": st["decode_steps"],
           "ms_per_step": 1e3 * st["decode_s"] / max(st["decode_steps"], 1),
           "cache_bytes": st["cache_bytes"],
           "launches": launches, "paths": paths, "peak_memory_bytes": peak,
           "batch_vs_oracle": rows, "tol": KVF8_TOL, "logit_scale": scale,
           "oracle_f8_vs_wider": vs_f32,
           "phase_s": time.perf_counter() - t0}
    emit(out)
    gen = kernel_gen()
    D = cfg32.attention.head_dim
    a = cfg32.attention
    Skv = S + new - 1                 # the last decode step's keys
    kernels = {"flash_e4m3": ([
        check_flash_e4m3(gen, f"e4m3_decode_b{B}_skv{Skv}", B, a.num_heads,
                         a.num_kv_heads, 1, Skv, D, kv_offset=Skv - 1),
        check_flash_e4m3(gen, f"e4m3_prefill_b1_s{S}", 1, a.num_heads,
                         a.num_kv_heads, S, S, D)],
        f"e4m3_decode_b{B}_skv{Skv}")}
    del engine, params
    torch.cuda.empty_cache()
    return {"launches": launches, "paths": paths, "kernels": kernels}


class DuckMesh:
    """A mesh's names and shape, no devices (``repro``'s test fake):
    enough for the rule engine."""

    def __init__(self, shape, names):
        self.devices = np.zeros(shape)
        self.axis_names = names


def spec_bytes(leaves, mesh):
    """(bytes of every leaf, the most one device holds under the rule
    engine's specs on ``mesh``, the same replicated)."""
    from repro_torch.dist import sharding as sh
    specs = sh.param_specs(leaves, mesh)
    total = per = 0
    for name, t in leaves.items():
        nb = t.numel() * t.element_size()
        total += nb
        per += math.prod(sh.local_shape(t.shape, specs[name], mesh)) \
            * t.element_size()
    return total, per


def phase_dist(cfg):
    """The distribution layer on one card: this host's one-rank NCCL mesh
    (``launch/mesh.py:make_host_mesh``): ``wire_allreduce_int8`` over
    tinyllama-1.1b's gradients (full width and depth, one backward of 2 x
    64 tokens) against the CPU's int8 round trip of each with
    ``q_sym``'s float32 scale (bit-equal); the batch ``Engine`` with
    ``mesh=`` a second (1, 1) mesh built by ``make_mesh``, against its
    path run by hand with no policy entered (equal tokens); the rule
    engine's specs of tinyllama's
    full parameters and baked planes on a duck (16, 16) mesh and the bytes
    one device would hold; then the process group is destroyed."""
    import torch.distributed as dist
    from repro_torch.dist import ctx as dist_ctx
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import grad_compression as gc_lib
    t0 = time.perf_counter()
    mesh = mesh_lib.make_host_mesh()
    info = {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": list(mesh.mesh_dim_names), "shape": list(mesh.shape)}
    model = init_params(cfg, seed=SEED + 7, device=DEVICE)
    batch = SyntheticLM(cfg, batch=2, seq=64, seed=SEED)(0)
    state = ts.init_state(cfg, adamw.AdamWConfig(), model=model)
    _, _, grads = ts.make_train_step(cfg, adamw.AdamWConfig()).grads(
        state, {n: t.to(DEVICE) for n, t in batch.items()})
    flat = {f"{i}.{j}": g for i, gs in enumerate(grads)
            for j, g in enumerate(gs)}
    got = gc_lib.wire_allreduce_int8(flat, mesh, axis="data")
    torch.cuda.synchronize()
    # the CPU's round trip with q_sym's own float32 scale, over n = 1 rank:
    # the card's division, rounding and dequantization are IEEE float32
    # both sides, so every tensor must be bit-equal
    exact, worst = 0, 0.0
    for name, g in flat.items():
        gc_ = g.float().cpu()
        scale = torch.clamp(gc_.abs().max(), min=1e-12) / 127.0
        codes = torch.clamp(torch.round(gc_ / scale), -127, 127)
        want = (codes * scale / 1).to(g.dtype)
        err = max_err(got[name].cpu().float(), want.float())
        worst = max(worst, err / float(scale))
        exact += int(torch.equal(got[name].cpu(), want))
    if exact != len(flat):
        raise AssertionError(f"dist: wire all-reduce bit-equal on {exact} "
                             f"of {len(flat)} tensors, off by {worst} steps")
    del grads, state, got
    # the engine under the policy of a mesh built explicitly, against the
    # batch engine's path run by hand with no policy entered
    explicit = mesh_lib.make_mesh((1, 1), ("data", "model"))
    if explicit is mesh:
        raise AssertionError("dist: make_mesh returned the host mesh")
    rng = np.random.RandomState(SEED + 7)
    prompts = rng.randint(0, cfg.vocab_size, size=(4, 48)).astype(np.int32)
    reqs = [Request(prompt=p, max_new_tokens=8, id=i)
            for i, p in enumerate(prompts)]
    eng = Engine(cfg, model, max_batch=4, max_seq=128, device=DEVICE,
                 mesh=explicit, bucket_prompts=False)
    tokens = {"mesh": [r["tokens"] for r in eng.generate(reqs)]}
    if dist_ctx.current_policy() is not None:
        raise AssertionError("dist: the engine left its policy entered")
    tokens["no_policy"] = [t for t, _ in batch_traces(cfg, model, prompts,
                                                      8)]
    if tokens["mesh"] != tokens["no_policy"]:
        raise AssertionError(f"dist: Engine(mesh=) tokens {tokens}")
    duck = DuckMesh((16, 16), ("data", "model"))
    leaves = {n: p for n, p in model.named_parameters()}
    serving = dict(leaves)
    serving.update((n, b) for n, b in model.named_buffers()
                   if b is not None)
    full = {}
    for name, ls in (("params", leaves), ("serving", serving)):
        total, per = spec_bytes(ls, duck)
        full[name] = {"bytes": total, "per_device_bytes": per,
                      "ratio": total / per}
    dist.destroy_process_group()
    emit({"phase": "dist", **info, "wire_allreduce": {
        "tensors": len(flat), "bit_equal": exact},
        "engine_tokens_equal_no_policy": True,
        "tokens": tokens["mesh"], "duck_mesh": [16, 16],
        "rule_engine": full, "destroyed": not dist.is_initialized(),
        "phase_s": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()


GRAPH_LENS = (40, 17, 100, None, 64, 23, 200, 90)    # None: an idle slot
GRAPH_BUDGETS = (20, 3, 13, 0, 9, 0, 17, 5)          # slot 5 stalled


def graph_state(cfg, params, policy):
    """The serve phase's 8 slots after their prefills (B=1, right-padded,
    packed into pages as the engine packs them): pool, table, and each
    slot's token, position and budget."""
    page, maxp = 16, kvc.pages_for(256, 16)
    pool = kvc.build_pool(cfg, 8 * maxp + 1, page, policy, device=DEVICE)
    table = np.zeros((8, maxp), np.int32)
    cur, pos, rem = (np.zeros(8, np.int32) for _ in range(3))
    rng = np.random.RandomState(SEED + 6)
    nxt_page = 1
    for b, (S, budget) in enumerate(zip(GRAPH_LENS, GRAPH_BUDGETS)):
        if S is None:
            pos[b] = -1
            continue
        n = kvc.pages_for(S + max(budget, 1), page)
        table[b, :n] = np.arange(nxt_page, nxt_page + n)
        nxt_page += n
        n_pre = kvc.pages_for(S, page)
        toks = np.zeros(n_pre * page, np.int64)
        toks[:S] = rng.randint(0, cfg.vocab_size, size=S)
        with torch.no_grad():
            first, _, pool, _ = dec.make_prefill_pack_step(cfg, n_pre, page)(
                params, {"tokens": torch.as_tensor(toks[None],
                                                   device=DEVICE)},
                pool, torch.as_tensor(table[b, :n_pre], dtype=torch.int64,
                                      device=DEVICE), S)
        cur[b], pos[b], rem[b] = int(first), S, budget
    return pool, table, cur, pos, rem


def run_loop(loop, params, pool, table, cur, pos, rem, dispatches=3):
    """``dispatches`` calls of the loop carrying the state, as the engine
    makes them: the outputs of each, the decode steps and the seconds."""
    state = [torch.as_tensor(a) for a in (cur, pos, rem)]
    tab = torch.as_tensor(table, device=DEVICE)
    outs, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(dispatches):
            buf, c, pool, p, r, done, anom, n = loop(params, state[0], pool,
                                                     tab, state[1], state[2])
            outs.append([t.cpu() for t in (buf, c, p, r, done, anom)])
            steps += n
            state = [c, p, r]
    torch.cuda.synchronize()
    return outs, steps, time.perf_counter() - t0


def phase_decode_graph(cfg):
    """On every pool lane (f32 and bf16 pools on the stream path, the gather
    path, the int8 pool with int8 planes), greedy and sampled: the paged
    decode loop replayed from its CUDA graph against the same loop run
    eagerly, from the same slots (``graph_state``) over 3 dispatches of 8
    steps.  Tokens, positions, budgets, ``done``, ``anom``, step counts and
    every byte of the pool but the trash page must be equal; launch counts
    equal too.  Then a
    step that reads the card inside must fail to capture, and raise."""
    lanes = {"f32_stream": (codec.QuantPolicy("f32"), "stream"),
             "bf16_stream": (codec.QuantPolicy("bf16"), "stream"),
             "f32_gather": (codec.QuantPolicy("f32"), "gather"),
             "int8_stream": (codec.QuantPolicy("int8", quant_weights=True),
                             "stream")}
    rows = []
    for name, (policy, impl) in lanes.items():
        params = precompute_serving_params(
            init_params(cfg, seed=SEED, device=DEVICE), cfg, policy)
        pool, table, cur, pos, rem = graph_state(cfg, params, policy)
        for sample in (False, True):
            runs = {}
            for graphs in (False, True):
                lp = {k: t.clone() for k, t in pool.items()}
                loop = dec.make_paged_decode_loop(
                    cfg, 8, sample=sample, seed=7, paged_impl=impl,
                    graphs=graphs)
                with torch.no_grad():
                    loop.slots(params, lp, 8, table.shape[1])
                for lib in LIBRARIES:
                    lib.reset_counts()
                outs, steps, secs = run_loop(loop, params, lp, table, cur,
                                             pos, rem)
                runs[graphs] = (outs, steps, secs, lp, lane_counts(), loop)
            (eo, es, et, ep, el, _), (go, gs, gt, gp, gl, gloop) = (
                runs[False], runs[True])
            state_equal = all(torch.equal(a, b) for x, y in zip(eo, go)
                              for a, b in zip(x, y))
            # every page but the trash page 0, whose writes are unordered
            # (and which the capture's warm-up writes too)
            pool_equal = all(torch.equal(ep[k][:, 1:], gp[k][:, 1:])
                             for k in ep)
            if not (state_equal and pool_equal and es == gs and el == gl):
                raise AssertionError(
                    f"decode_graph {name} sample={sample}: state "
                    f"{state_equal}, pool {pool_equal}, steps {es}/{gs}, "
                    f"launches {el} / {gl}")
            rows.append({"lane": name, "sample": sample, "steps": gs,
                         "state_equal": state_equal, "pool_equal": pool_equal,
                         "launches": gl, "captures": gloop.captures,
                         "capture_s": gloop.capture_s,
                         "eager_ms_per_step": 1e3 * et / es,
                         "replay_ms_per_step": 1e3 * gt / gs,
                         "tokens": [o[0].tolist() for o in go]})
        del params, pool
        torch.cuda.empty_cache()
    params = precompute_serving_params(
        init_params(cfg, seed=SEED, device=DEVICE), cfg)
    pool, table, *_ = graph_state(cfg, params, codec.QuantPolicy())
    bad = dec.make_paged_decode_loop(cfg, 8, graphs=True)
    step = bad.step

    def syncing(params, st, pool):            # a host read inside the step
        step(params, st, pool)
        bool(st.done.any())

    bad.step = syncing
    try:
        with torch.no_grad():
            bad.slots(params, pool, 8, table.shape[1])
    except RuntimeError as e:
        refused = str(e).splitlines()[0][:200]
    else:
        raise AssertionError("a step that syncs was captured")
    emit({"phase": "decode_graph", "arch": ARCH, "slots": 8, "chunk": 8,
          "lanes": rows, "failed_capture_raises": refused})
    del params, pool
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvidia_smi": card, "device": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count()})
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
                        or "spill" in ln or "Compiling entry" in ln]
                    for n in build.KERNEL_NAMES}})
    cfg = get_config(ARCH)
    kernels = phase_kernels(cfg)
    runs = {"serve_smoke": phase_serve_smoke(), "serve": phase_serve(cfg)}
    phase_parity(cfg)
    for bits in (8, 4):
        runs[f"serve_quant_int{bits}"] = phase_serve_quant(cfg, bits)
    runs["serve_gather"] = phase_serve_gather(cfg)
    phase_quant_parity(cfg)
    runs["serve_batch"] = phase_serve_batch(cfg)
    phase_serve_batch_quant(cfg)
    phase_batch_parity(cfg)
    phase_serve_qwen()
    for arch, out in ((PHI3, phase_serve_phi3()), (MOE, phase_serve_moe())):
        for engine in ("continuous", "batch", "oracle"):
            runs[f"{arch}/{engine}"] = out[engine]
    for arch, out in phase_serve_batch_archs().items():
        for engine in ("batch", "oracle"):
            runs[f"{arch}/{engine}"] = out[engine]
    runs.update(phase_serve_fused(cfg))
    phase_serve_obs(cfg)
    chaos_params = init_params(cfg.replace(dtype="float32"), seed=SEED,
                               device=DEVICE)
    phase_serve_chaos(cfg, chaos_params)
    phase_serve_fleet(cfg, chaos_params)
    del chaos_params
    conv_run = phase_conv()
    kernels.update(conv_run.pop("kernels"))
    runs["conv"] = conv_run
    conv_run = phase_conv(4)
    kernels.update(conv_run.pop("kernels"))
    runs["conv_k4"] = conv_run
    block_kernels, block_runs = phase_block_sizes(cfg)
    kernels.update(block_kernels)
    runs.update(block_runs)
    kvf8_run = phase_serve_kvf8(cfg)
    record_kernels(kernels, kvf8_run.pop("kernels"))
    runs["serve_kvf8"] = kvf8_run
    phase_decode_graph(cfg)
    runs["train"] = phase_train(cfg)
    phase_train_parity(cfg)
    phase_train_dense(cfg, runs["train"])
    for arch, t in TRAIN_ARCHS.items():
        runs[t["phase"]] = phase_train_arch(arch)
    for arch in TRAIN_ARCHS:
        phase_train_parity_arch(arch)
    phase_dist(cfg)
    runs.update(phase_nogauss(cfg))
    phase_lowering(cfg, kernel_gen())
    phase_dryrun(start_dryruns())
    summary = []
    for name, (lib, replaces, group, main_case, run) in (
            list(LANES.items()) + list(NEW_SHAPES.items())):
        cases, _ = kernels[group]
        c = next(c for c in cases if c["case"] == main_case)
        fn = name.split("@")[0]
        launches = runs[run]["launches"][fn]
        extra = {}
        if name in SHAPE_PATHS:
            extra = {"lane_launches": launches, "path": SHAPE_PATHS[name]}
            launches = runs[run]["paths"].get(lib.name, {}).get(
                SHAPE_PATHS[name], 0)
        if "shapes" in runs[run]:        # the batch-only archs' runs
            key = "path_launches" if name in SHAPE_PATHS else "lane_launches"
            extra.update({key: launches, "launch_shape": c["launch_shape"]})
            launches = runs[run]["shapes"].get(lib.name, {}).get(
                c["launch_shape"], 0)
        if not launches:
            raise AssertionError(f"{name}: no launch in the {run} run")
        summary.append({
            "name": name, "route": "cuda",
            "source": str(lib.source.relative_to(ROOT)),
            "replaces": replaces, "launches": launches, "launches_in": run,
            **extra,
            "case": main_case, "max_abs_err": c["max_abs_err"],
            "tol": c["tol"], "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
            "device_ms": c["device_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_us": c["bound_ms"] * 1e3, "bound_by": c["bound_by"],
            "bound_share": c["bound_share"], "library_ms": c["library_ms"]})
    summary += smoke_lane_summary(kernels, runs)
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
