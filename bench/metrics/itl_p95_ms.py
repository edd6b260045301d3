"""The 95th percentile over every output token after a request's first
delivered in the window of its gap: the milliseconds since the request's
previous delivery, divided by the tokens delivered together (tokens
delivered with the first token have the gap 0)."""
from bench.lib import stats


def read(rec):
    if rec.get("kind") != "serve":
        return None
    t0, t1 = rec["t_open"], rec["t_close"]
    xs = [g for tr in rec["tracks"]
          for g in stats.token_gaps(tr.deliveries, t0, t1)]
    return 1e3 * stats.percentile(xs, 95) if xs else None
