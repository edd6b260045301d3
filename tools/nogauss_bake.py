#!/usr/bin/env python3
"""Where the greedy tokens of the 4-product lane (``gauss_trick=False``) on
a CUDA card can part from the CPU's, on tinyllama-1.1b's smoke config in
float32.

    PYTHONPATH=src python3 tools/nogauss_bake.py [--out FILE]

Requests: three prompts of 12 tokens (budgets 9, 14, 6), so that the
batch engine (``bucket_prompts=False``) pads no row and both engines
compute what a B = 1 run computes.  The reference is the batch engine on
the CPU, on weights drawn and planes baked on the CPU
(``init_params(seed=0)``, ``precompute_serving_params``).  Three ways of
making the card's weights, each served by both engines (``Engine``,
``ContinuousEngine``) on the card:

* ``cpu_baked``: the CPU's baked weights copied to the card;
* ``card_baked``: the CPU's drawn weights copied to the card and baked
  there;
* ``card_drawn``: weights drawn on the card from the same seed and baked
  there (``init_params(device="cuda")``: its generator lives on the card,
  which draws other numbers than the CPU's from one seed).

For each it prints one JSON line: the largest absolute difference of the
drawn parameters and of the baked wr / wi planes against the CPU's (and
the planes' largest magnitude), and for each engine and request the first
token that differs from the CPU's, the CPU's top-2 logit gap there (a
teacher-forced float32 B = 1 prefill on the CPU) and the logit scale.  A
last line (``case: padding``) serves prompts of 20, 12 and 9 tokens on
the CPU through both engines: the batch engine left-pads the shorter
prompts to a bucket, and its padded rows are another computation than the
continuous engine's B = 1 prefills (first differing token per request).
Exits 2 without a CUDA device.
"""
import argparse
import copy
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import init_params
from repro_torch.quant import codec
from repro_torch.serve.engine import ContinuousEngine, Engine, Request
from repro_torch.serve.params import precompute_serving_params

# prompts and budgets: equal lengths (tests/test_torch_cuda.py's
# card-baked case), and the lengths the batch engine pads
SPECS = [(12, 9), (12, 14), (12, 6)]
PADDED = [(20, 9), (12, 14), (9, 6)]
ENGINES = (("batch", Engine, dict(bucket_prompts=False)),
           ("continuous", ContinuousEngine,
            dict(max_slots=2, max_seq=32, page_size=4, decode_chunk=4)))


def config():
    cfg = get_smoke_config("tinyllama-1.1b")
    return cfg.replace(dtype="float32", compression=dataclasses.replace(
        cfg.compression, gauss_trick=False))


def requests(specs=SPECS):
    rng = np.random.RandomState(0)
    return [Request(prompt=rng.randint(1, 500, size=s).astype(np.int32),
                    max_new_tokens=n, id=i) for i, (s, n) in enumerate(specs)]


def first_diff(got, want):
    return next((i for i in range(max(len(got), len(want)))
                 if i >= len(got) or i >= len(want) or got[i] != want[i]),
                None)


def top2_gap(cfg, params, prompt, tokens, i):
    """(top-2 logit gap, logit scale) of the CPU's model at generated
    token ``i``: a teacher-forced float32 prefill of the prompt and the
    first ``i`` tokens."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:i], np.int64)])
    model = build_model(cfg)
    with torch.no_grad():
        cache = model.init_cache(1, len(seq), dtype=torch.float32,
                                 device="cpu")
        logits, _ = model.prefill(params, {
            "tokens": torch.as_tensor(seq[None])}, cache)
    row = logits[0, -1].float()
    top = torch.topk(row, 2).values
    return float(top[0] - top[1]), float(row.abs().max())


def max_diff(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double())
                 .abs().max())


def plane_diffs(card, ref):
    """Largest |card - ref| over the baked wr and wi planes, and the
    planes' largest magnitude."""
    got = {(m, p): c for m, _, p, c in codec.baked_caches(card)}
    diff = scale = 0.0
    for path, _, prefix, want in codec.baked_caches(ref):
        for name in ("wr", "wi"):
            diff = max(diff, max_diff(got[path, prefix][name], want[name]))
            scale = max(scale, float(want[name].abs().max()))
    return diff, scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nogauss_bake: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    drawn = init_params(cfg, seed=0, device="cpu")
    ref = precompute_serving_params(copy.deepcopy(drawn), cfg)
    reqs = requests()
    want = [r["tokens"] for r in Engine(cfg, copy.deepcopy(ref),
                                        device="cpu", bucket_prompts=False
                                        ).generate(reqs)]
    cases = {
        "cpu_baked": lambda: copy.deepcopy(ref).to("cuda"),
        "card_baked": lambda: precompute_serving_params(
            copy.deepcopy(drawn).to("cuda"), cfg),
        "card_drawn": lambda: precompute_serving_params(
            init_params(cfg, seed=0, device="cuda"), cfg)}
    lines = []
    for name, make in cases.items():
        params = make()
        drawn_diff = max(max_diff(a, b) for (_, a), (_, b) in zip(
            params.named_parameters(), drawn.named_parameters()))
        planes, scale = plane_diffs(params, ref)
        out = {"case": name, "device": torch.cuda.get_device_name(0),
               "param_max_abs_diff": drawn_diff,
               "plane_max_abs_diff": planes, "plane_absmax": scale,
               "cpu_tokens": want, "engines": {}}
        for label, engine, kw in ENGINES:
            got = [r["tokens"] for r in engine(
                cfg, copy.deepcopy(params), device="cuda",
                **kw).generate(reqs)]
            rows = []
            for req, g, w in zip(reqs, got, want):
                at = first_diff(g, w)
                row = {"id": req.id, "first_diff": at, "tokens": g}
                if at is not None and at < len(w):
                    row["cpu_gap"], row["logit_scale"] = top2_gap(
                        cfg, ref, req.prompt, w, at)
                rows.append(row)
            out["engines"][label] = rows
        lines.append(out)
        print(json.dumps(out), flush=True)
        del params
        torch.cuda.empty_cache()
    padded = requests(PADDED)
    toks = {"batch": [r["tokens"] for r in Engine(
        cfg, copy.deepcopy(ref), device="cpu").generate(padded)]}
    toks["continuous"] = [r["tokens"] for r in ContinuousEngine(
        cfg, copy.deepcopy(ref), device="cpu", **ENGINES[1][2]
    ).generate(padded)]
    out = {"case": "padding", "device": "cpu", "tokens": toks,
           "first_diff": [first_diff(b, c) for b, c in zip(
               toks["batch"], toks["continuous"])]}
    lines.append(out)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
