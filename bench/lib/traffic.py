"""The one generator of the benchmark's traffic: it reads a mix's data file
(``traffic/<name>.json``) and the seed, and gives the requests (or the
training batches) a run sends.

Every seed sends the same set of sizes: prompt and output lengths are the
quantiles of the mix's distributions at ``(i + 0.5) / n`` for the mix's
``requests`` = n, paired once by a fixed permutation.  The seed decides
their order and the token ids, so two seeds do the same work in another
order.  The order is stratified (``stratified_order``): every run of
``block`` consecutive requests holds one prompt length from each of
``block`` strata, so any stretch of a run asks for the same mixture of
sizes whatever the seed.

Arrivals are not stratified.  Kind ``poisson``: a Poisson process at the
mix's rate, conditioned on its count over the ramp and the window
(``arrival_times``): N = rate x span arrival times, each uniform over the
span and drawn from the seed.  Every seed offers the same number of
requests, and the bursts fall where the seed puts them, as in a Poisson
process.  Kind ``poisson_trace``: one such draw, made once from the mix's
``trace_seed`` for the ramp and once for the window, each turned on its
own circle by the same fraction drawn from the seed.  Every seed offers
the window the same arrivals, bursts and all, in a rotated order, so a
tail that hangs on a few bursts reads alike from seed to seed.

Serving mix keys:

* ``extends``: the name of another mix whose keys this one starts from;
  its own keys replace them whole;
* ``arrivals``: ``{"kind": "poisson", "rate": r}``: an open loop at r
  requests a second; ``{"kind": "poisson_trace", "rate": r,
  "trace_seed": t}``: the fixed draw t, rotated by the seed;
* ``initial_requests``: C requests sent together when the ramp starts;
  request i of them stops after its output length times (i + 0.5) / C,
  so the window opens on a mixed population;
* ``requests``: how many sizes the set holds (cycled if a run needs more);
* ``block``: the strata of the order (1: a plain shuffle); it divides
  ``requests``;
* ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "lo", "hi"}``, in tokens; the prompt's text, after the configuration's
  patch slots;
* ``engine``: the ``ContinuousEngine`` settings of the cell;
* ``ramp_s``: seconds of load before the window opens;
* ``trace``: ``{"after_s", "slice_s"}``, the slice of the window a traced
  run profiles;
* ``check``: ``{"requests": n}``, how many finished requests the
  reference judges (the one with the most served tokens among them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Req:
    prompt: np.ndarray                 # (S,) int32, patch slots included
    max_new_tokens: int


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """The standard normal's quantile function (Acklam's rational
    approximation, relative error below 1.2e-9)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    p = np.asarray(p, np.float64)
    out = np.empty_like(p)
    lo, hi = p < 0.02425, p > 1 - 0.02425
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(p[lo]))
    out[lo] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = np.sqrt(-2 * np.log(1 - p[hi]))
    out[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                 + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                            + 1))
    q = p[mid] - 0.5
    r = q * q
    out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                 + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                 * r + b[4]) * r + 1))
    return out


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """The n lengths at quantiles (i + 0.5) / n of ``dist``, clipped to
    its ``[lo, hi]`` and rounded."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] != "lognormal":
        raise ValueError(f"length distribution {dist['dist']!r}")
    x = dist["median"] * np.exp(dist["sigma"] * _norm_ppf(u))
    return np.clip(np.rint(x), dist["lo"], dist["hi"]).astype(np.int64)


def size_set(mix: Dict) -> List[tuple]:
    """The mix's (prompt, output) pairs, the same for every seed."""
    n = int(mix["requests"])
    prompts = quantile_lengths(mix["prompt"], n)
    outputs = quantile_lengths(mix["output"], n)
    pairing = np.random.default_rng(0).permutation(n)
    return [(int(p), int(outputs[j])) for p, j in zip(prompts, pairing)]


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % (1 << 64))


def stratified_order(n: int, block: int,
                     rng: np.random.Generator) -> np.ndarray:
    """A permutation of the indices ``0 .. n-1`` of n items sorted by size
    in which every run of ``block`` consecutive places holds one item of
    each of ``block`` strata (the sorted items cut into ``block`` equal
    ranges).  The seed's generator draws which item of each stratum goes
    to which run, and the order inside each run."""
    if n % block:
        raise ValueError(f"block {block} does not divide {n} items")
    strata = np.arange(n).reshape(block, n // block)
    runs = np.stack([rng.permutation(row) for row in strata]).T
    return np.concatenate([run[rng.permutation(block)] for run in runs])


def requests(mix: Dict, seed: int, vocab: int, prefix: int) -> List[Req]:
    """The mix's requests in the seed's order: ``prefix`` patch slots (id
    0; the engine replaces them) then the prompt's text tokens, ids
    uniform over the vocabulary."""
    rng = seed_rng(seed)
    sizes = size_set(mix)
    by_prompt = np.argsort([p for p, _ in sizes], kind="stable")
    order = by_prompt[stratified_order(len(sizes), int(mix["block"]), rng)]
    out = []
    for i in order:
        s, o = sizes[i]
        prompt = np.zeros(prefix + s, np.int32)
        prompt[prefix:] = rng.integers(0, vocab, size=s, dtype=np.int32)
        out.append(Req(prompt, o))
    return out


def first_budgets(mix: Dict, reqs: List[Req]) -> List[int]:
    """The staggered budgets of the ``initial_requests`` = C requests sent
    when the ramp starts: request i stops after ``ceil(out * (i + 0.5) /
    C)`` tokens."""
    C = int(mix["initial_requests"])
    return [max(1, math.ceil(reqs[i].max_new_tokens * (i + 0.5) / C))
            for i in range(min(C, len(reqs)))]


def arrival_times(mix: Dict, seed: int, span: float) -> np.ndarray:
    """The open loop's arrival times (seconds after the ramp starts, in
    ascending order) over ``span`` seconds: a Poisson process at the mix's
    rate conditioned on its count, ``round(rate * span)`` times uniform
    over the span, drawn from the seed; or, for ``poisson_trace``, the
    ramp's and the window's fixed draws, rotated by the seed."""
    arr = mix["arrivals"]
    rate = float(arr["rate"])
    if arr["kind"] == "poisson":
        n = int(round(rate * span))
        rng = seed_rng(seed ^ 0x5EED)
        return np.sort(rng.uniform(0.0, span, size=n))
    if arr["kind"] != "poisson_trace":
        raise ValueError(f"open-loop arrivals {arr['kind']!r}")
    ramp = min(float(mix.get("ramp_s", 0.0)), span)
    turn = seed_rng(seed ^ 0x5EED).uniform()
    parts = []
    for part, (lo, length) in enumerate(((0.0, ramp), (ramp, span - ramp))):
        n = int(round(rate * length))
        fixed = np.random.default_rng([int(arr["trace_seed"]), part])
        t = fixed.uniform(0.0, length, size=n)
        parts.append(lo + np.sort((t + turn * length) % length))
    return np.concatenate(parts)
