"""Serving launcher for the port: the batch-synchronous engine (the
default, as in ``repro``) or the continuous-batching engine over the paged
KV pool, on the CUDA card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --device cpu --requests 4 --new-tokens 8 --sample
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --engine continuous --device cpu --kv-dtype int8 --quant-weights \\
      --paged-attn gather

Weights are random, drawn from ``--seed`` (no checkpoint is loaded).
Prompts are 16-31 random tokens; a ``vision_stub`` arch (phi-3-vision)
gets ``num_patches`` more, the slots its zero patch embeddings replace, as
an image-plus-text request would, and a sliding-window arch (mixtral,
gemma2, recurrentgemma) its largest window more, so that its ring cache's
prefill can fill the ring.  An encoder-decoder (whisper) encodes zero
frames.  mixtral, gemma2, recurrentgemma, xlstm and whisper are served by
the batch engine only: ``--engine continuous`` refuses them, as
``repro``'s launcher does.

Telemetry (``repro_torch.obs``, on unless ``--no-obs``): ``--metrics-out``
writes registry snapshots and request traces as JSONL every
``--metrics-every`` dispatches (``python -m repro_torch.obs --validate``
checks it), ``--trace-out`` a Chrome trace of the dispatches and requests
(``python -m repro_torch.obs.chrometrace --validate``), ``--slo`` runs the
SLO watchdog (``--slo-rules`` a JSON list of rules), ``--shadow-sample``
replays that fraction of finished requests through the float32 oracle
(continuous engine), and ``--hardware`` names the spec the profiler
prices dispatches against (default: the device's).  The run ends with
the pool-pressure, roofline, health and obs-summary lines.

The continuous engine's admission and lifecycle flags are ``repro``'s:
``--max-tokens-in-flight``, ``--admission``, ``--max-queue``,
``--max-preemptions``, ``--deadline-s`` (a deadline on every request) and
``--no-precompute`` (both engines).  ``--replicas N`` (continuous only)
serves through a fleet of N engines sharing the weights behind the
health-checked failover router (``repro_torch.fleet``; ``--router-policy``,
``--hedge-after``), and prints the fleet's and each replica's summary:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --engine continuous --device cpu --replicas 2 --requests 6

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --engine continuous --device cpu --requests 4 --new-tokens 6 \\
      --metrics-out m.jsonl --metrics-every 2 --trace-out t.json --slo
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..device import resolve_device
from ..fleet import EngineReplica, Router
from ..kernels import build
from ..models.registry import init_params
from ..models.transformer import layer_kinds, window_for
from ..obs import Obs, resolve_hardware
from ..obs.chrometrace import write_trace
from ..obs.slo import SloWatchdog, rules_from_json
from ..quant.codec import QuantPolicy
from ..roofline.analysis import HARDWARE_PRESETS
from ..serve.engine import ContinuousEngine, Engine, Request
from ..serve.kvcache import servable_reasons


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--engine", default="batch",
                    choices=["batch", "continuous"],
                    help="batch-synchronous engine or the continuous-"
                         "batching engine over the paged KV pool")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="batch size (batch engine) or decode slots "
                         "(continuous engine)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per dispatch")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and the "
                         "sampling noise")
    ap.add_argument("--sample", action="store_true",
                    help="sample at temperature 1 instead of greedy")
    ap.add_argument("--decode-mode", default="scan",
                    choices=["scan", "per_token"],
                    help="batch engine: the decode loop (default) or one "
                         "decode-step call per token")
    ap.add_argument("--no-bucket", action="store_true",
                    help="batch engine: disable prompt-length bucketing")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--max-tokens-in-flight", type=int, default=None,
                    help="continuous: admission token budget")
    ap.add_argument("--admission", default="optimistic",
                    choices=["optimistic", "reserve"],
                    help="continuous: optimistic page admission (preempt on "
                         "exhaustion) or worst-case reservation")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="continuous: bounded submit queue; requests beyond "
                         "it are REJECTED (backpressure)")
    ap.add_argument("--max-preemptions", type=int, default=4,
                    help="continuous: per-request preemption bound before a "
                         "slot stalls instead of thrashing")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="continuous: per-request deadline (seconds from "
                         "arrival); expired requests go terminal TIMEOUT")
    ap.add_argument("--no-precompute", action="store_true",
                    help="skip the offline spectral-weight pass")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous: serve through a replicated fleet of N "
                         "engines behind the health-checked failover router "
                         "(repro_torch.fleet); telemetry gains a replica= "
                         "label")
    ap.add_argument("--router-policy", default="jsq",
                    choices=["jsq", "round_robin"],
                    help="with --replicas: join-shortest-queue placement "
                         "(default) or round-robin")
    ap.add_argument("--hedge-after", type=float, default=None,
                    metavar="SECONDS",
                    help="with --replicas: hedge a request to a second "
                         "replica if its first token takes longer than this "
                         "(default: adaptive, 4x the fleet's p99 TTFT)")
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
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write obs JSONL telemetry (registry snapshots + "
                         "request traces) to FILE; check it with python -m "
                         "repro_torch.obs --validate FILE")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="with --metrics-out: flush every N engine "
                         "dispatches")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable traces, histograms, profiler spans and "
                         "the numerics capture (counters stay live)")
    ap.add_argument("--shadow-sample", type=float, default=0.0,
                    metavar="FRAC",
                    help="continuous: replay this fraction of FINISHED "
                         "requests through the float32 dense-cache oracle "
                         "between dispatches (health.greedy_agreement / "
                         "health.logit_drift)")
    ap.add_argument("--slo", action="store_true",
                    help="run the SLO watchdog (obs/slo.py) over every "
                         "snapshot; alerts go to --metrics-out and are "
                         "summarized on exit")
    ap.add_argument("--slo-rules", default=None, metavar="RULES.json",
                    help="with --slo: a JSON list of Rule dicts instead of "
                         "the stock ruleset")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Perfetto-loadable Chrome trace of the "
                         "serve (dispatch lanes, one lane a request, "
                         "counter tracks) to FILE")
    ap.add_argument("--hardware", default="auto",
                    choices=["auto"] + sorted(HARDWARE_PRESETS),
                    help="roofline spec the profiler prices dispatches "
                         "against (auto: the device's)")
    args = ap.parse_args(argv)

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    if args.replicas > 1 and args.engine != "continuous":
        raise SystemExit("[launch.serve] --replicas > 1 requires "
                         "--engine continuous")
    if args.engine == "continuous":
        reasons = servable_reasons(cfg)
        if reasons:
            raise SystemExit(f"[launch.serve] {args.arch} is not continuous-"
                             f"servable ({'; '.join(reasons)}); "
                             f"use --engine batch")
    device = resolve_device(args.device)
    watchdog = None
    if args.slo:
        watchdog = SloWatchdog(rules_from_json(args.slo_rules)
                               if args.slo_rules else None)
    obs = Obs(enabled=not args.no_obs, emit_path=args.metrics_out,
              emit_every=args.metrics_every,
              hardware=resolve_hardware(args.hardware), slo=watchdog)
    params = init_params(cfg, seed=args.seed, device=device)
    quant = QuantPolicy(args.kv_dtype, args.quant_weights, args.weight_bits)
    # prompt slots ahead of the 16-31 text tokens: the patches, the window
    extra = cfg.num_patches if cfg.frontend == "vision_stub" else 0
    if not cfg.is_encoder_decoder:
        extra += max(window_for(k, cfg) for k in layer_kinds(cfg))
    max_seq = extra + 64 + args.new_tokens
    router = None
    if args.engine == "continuous":

        def make_engine(eng_obs):
            return ContinuousEngine(
                cfg, params, max_slots=args.max_batch, max_seq=max_seq,
                page_size=args.page_size,
                max_tokens_in_flight=args.max_tokens_in_flight,
                decode_chunk=args.decode_chunk, sample=args.sample,
                seed=args.seed, eos_id=args.eos_id,
                precompute=not args.no_precompute,
                paged_attn=args.paged_attn, quant=quant, obs=eng_obs,
                admission=args.admission, max_queue=args.max_queue,
                max_preemptions=args.max_preemptions,
                shadow_sample=args.shadow_sample, device=device)

        if args.replicas > 1:
            if device.type == "cuda":
                # a library built inside a replica's step would read as a
                # step timeout: build them all before the first replica
                build.build()
            pool = [EngineReplica(f"r{i}",
                                  make_engine(obs.scoped(replica=f"r{i}")))
                    for i in range(args.replicas)]
            router = Router(pool, policy=args.router_policy,
                            hedge_after_s=args.hedge_after, obs=obs,
                            seed=args.seed)
        else:
            engine = make_engine(obs)
    else:
        if args.kv_dtype != "f32":
            print(f"[launch.serve] note: --kv-dtype {args.kv_dtype} applies "
                  f"to the continuous engine's paged pool; the batch "
                  f"engine's dense cache stays f32 (parity oracle)")
        if args.shadow_sample > 0.0:
            print("[launch.serve] note: --shadow-sample applies to the "
                  "continuous engine (the batch engine is the f32 oracle)")
        engine = Engine(cfg, params, max_batch=args.max_batch,
                        max_seq=max_seq, sample=args.sample,
                        decode_mode=args.decode_mode, eos_id=args.eos_id,
                        seed=args.seed, bucket_prompts=not args.no_bucket,
                        quant=quant, obs=obs, device=device,
                        precompute=not args.no_precompute)
    rng = np.random.RandomState(args.seed)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=extra
                                       + rng.randint(16, 32)).astype(
        np.int32), max_new_tokens=args.new_tokens, id=i,
        deadline_s=args.deadline_s)
        for i in range(args.requests)]
    t0 = time.perf_counter()
    results = (router or engine).generate(reqs)
    dt = time.perf_counter() - t0
    toks = sum(r["decode_len"] for r in results)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if router is not None:
        # unserved terminals (TIMEOUT / REJECTED / ...) carry no prefill
        served = [r for r in results if r.get("prefill_s") is not None]
        pre = sum(r["prefill_s"] for r in served) / max(len(served), 1)
        deco = sum(r["decode_s"] for r in served) / max(len(served), 1)
        print(f"[launch.serve] {args.arch} (continuous x{args.replicas}) "
              f"on {name}: {len(results)} requests, {toks} tokens, "
              f"{dt:.2f}s ({toks / dt:.1f} tok/s; mean prefill "
              f"{pre * 1e3:.0f}ms / decode {deco * 1e3:.0f}ms)")
        rs = router.stats()
        nonzero = {s: n for s, n in rs["statuses"].items() if n}
        print(f"[launch.serve] fleet: policy={rs['policy']} "
              f"live={rs['live_replicas']}/{len(router.replicas)} "
              f"placed={rs['placed']} retries={rs['place_retries']} "
              f"hedges={rs['hedges']} failovers={rs['failovers']} "
              f"migrated={rs['migrated_requests']} shed={rs['shed']} "
              f"statuses={nonzero}")
        for rep in rs["replicas"]:
            e = rep["engine"]
            print(f"[launch.serve]   {rep['name']}: {rep['state']} "
                  f"served_statuses="
                  f"{ {s: n for s, n in e['statuses'].items() if n} } "
                  f"preempted={e['preempted']} "
                  f"peak_pages={e['peak_pages_in_use']} "
                  f"step_timeouts={rep['step_timeouts']}")
        router.drain()
        st = router.stats()
    else:
        st = engine.stats()
        print(f"[launch.serve] {args.arch} ({args.engine}) on {name}: "
              f"{len(results)} requests, {toks} tokens, {dt:.2f}s "
              f"({toks / dt:.1f} tok/s; prefill {st['prefill_s']:.2f}s / "
              f"decode {st['decode_s']:.2f}s)")
        if args.engine == "batch":
            statuses = {}
            for r in results:
                statuses[r["status"]] = statuses.get(r["status"], 0) + 1
            print(f"[launch.serve] lifecycle: statuses={statuses} "
                  f"batches={st['batches']} prefills={st['prefills']} "
                  f"decode_steps={st['decode_steps']} "
                  f"pad_waste={st['prompt_pad_waste']} "
                  f"decode_mode={args.decode_mode} sample={args.sample}")
            print(f"[launch.serve] quant={st['quant_policy']}")
        else:
            nonzero = {s: n for s, n in st["statuses"].items() if n}
            print(f"[launch.serve] lifecycle: statuses={nonzero} "
                  f"preempted={st['preempted']} anomalies={st['anomalies']} "
                  f"prefills={st['prefills']} "
                  f"decode_steps={st['decode_steps']} "
                  f"pool={st['pool_bytes'] / 1e6:.1f}MB "
                  f"buckets={st['prefill_buckets']}")
            print(f"[launch.serve] quant={st['quant_policy']} "
                  f"attention={st['attention_impl']} "
                  f"attn_bytes/token={st['attention_bytes_per_token']} "
                  f"decode_peak_est={st['decode_peak_bytes_est'] / 1e6:.1f}MB")
            print(f"[launch.serve] pool pressure: "
                  f"free_pages={st['free_pages']} min_free_pages={st['min_free_pages']} (low-water headroom "
                  f"of {engine.num_pages - 1} usable)")
            if st.get("health") is not None:
                h = st["health"]
                print(f"[launch.serve] health: nonfinite_dispatches="
                      f"{h['nonfinite_dispatches']} "
                      f"act_absmax_peak={h['act_absmax_peak']} "
                      f"kv_clip_rate={st['kv_clip_rate']}")
            if st.get("shadow_oracle") is not None:
                sh = st["shadow_oracle"]
                agree, drift = sh["greedy_agreement"], sh["logit_drift"]
                print(f"[launch.serve] shadow oracle: sampled={sh['sampled']} "
                      f"replays={sh['replays']} dropped={sh['dropped']} "
                      f"greedy_agreement="
                      f"{'n/a' if agree is None else f'{agree:.4f}'} "
                      f"logit_drift="
                      f"{'n/a' if drift is None else f'{drift:.4g}'}")
        if not args.no_obs and st.get("roofline"):
            print(f"[launch.serve] roofline ({st['hardware']}):")
            for kind, r in st["roofline"].items():
                if not r["dispatches"]:
                    continue
                print(f"  {kind:<22} n={r['dispatches']:<4} "
                      f"{r['achieved_flops_per_s'] / 1e9:8.2f} GFLOP/s  "
                      f"{r['achieved_bytes_per_s'] / 1e9:8.2f} GB/s  "
                      f"frac={r['roofline_frac']:.3g} ({r['bound']}-bound)")
    if args.metrics_out is not None:
        obs.close()                        # final snapshot + trailing traces
        print(f"[launch.serve] metrics: {obs.emitter.lines_written} "
              f"lines -> {args.metrics_out}")
    if watchdog is not None:
        ws = watchdog.stats()
        print(f"[launch.serve] slo: {ws['alerts']} alerts "
              f"({ws['page_alerts']} page) by_rule={ws['by_rule']}")
        for a in watchdog.alerts:
            print(f"[launch.serve]   {a['severity'].upper()} {a['rule']} "
                  f"{a['series']}: {a['value']:.6g} {a['op']} "
                  f"{a['threshold']:.6g}")
    if args.trace_out is not None:
        trace = write_trace(obs, args.trace_out,
                            extra_meta={"arch": args.arch,
                                        "engine": args.engine,
                                        "replicas": args.replicas})
        print(f"[launch.serve] chrome trace: "
              f"{len(trace['traceEvents'])} events -> {args.trace_out}")
    if not args.no_obs:
        print("[launch.serve] obs summary:")
        print(obs.summary())
    return {"results": results, "stats": st, "obs": obs}


if __name__ == "__main__":
    main()
