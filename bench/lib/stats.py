"""The arithmetic that turns a run's timeline into its end-to-end numbers:
percentiles, rates and the gaps between a request's tokens.

A request's timeline is its submit time and its deliveries: ``(t, n)``
pairs, ``n`` tokens handed to the client together at time ``t`` (the
first delivery holds the first token).  Every tail is taken over all
samples of the window, every rate over all the work and all the time of
the window.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    sample with at least ``q`` percent of the samples at or below it.  A
    missing sample (a request that failed) is ``inf`` and sorts last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: float, seconds: float) -> float:
    """``count`` over ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return count / seconds


def ttft_samples(requests, t_open: float, t_close: float) -> List[float]:
    """Seconds from submit to first token of every request whose first
    token falls in ``[t_open, t_close]``; a request that ended in the
    window without a first token (failed or refused) gives ``inf``."""
    out = []
    for r in requests:
        if r.deliveries:
            t1 = r.deliveries[0][0]
            if t_open <= t1 <= t_close:
                out.append(t1 - r.submit_t)
        elif r.end_t is not None and t_open <= r.end_t <= t_close:
            out.append(math.inf)
    return out


def token_gaps(deliveries: Sequence[Tuple[float, int]], t_open: float,
               t_close: float) -> List[float]:
    """The gap of every token after a request's first that is delivered in
    the window: the time since the request's previous delivery, divided
    by the number of tokens delivered together.  Tokens delivered
    together with the first token come with it: their gap is 0."""
    out: List[float] = []
    prev = None
    for i, (t, n) in enumerate(deliveries):
        rest = n - 1 if i == 0 else n        # the first token is no gap
        if rest > 0 and t_open <= t <= t_close:
            gap = 0.0 if i == 0 else (t - prev) / n
            out.extend([gap] * rest)
        prev = t
    return out


def tokens_in(deliveries: Sequence[Tuple[float, int]], t_open: float,
              t_close: float) -> int:
    """Tokens delivered in ``[t_open, t_close]``."""
    return sum(n for t, n in deliveries if t_open <= t <= t_close)

