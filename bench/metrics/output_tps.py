"""Output tokens delivered to clients during the window, over the
window's seconds."""
from bench.lib import stats


def read(rec):
    if rec.get("kind") != "serve":
        return None
    t0, t1 = rec["t_open"], rec["t_close"]
    n = sum(stats.tokens_in(tr.deliveries, t0, t1) for tr in rec["tracks"])
    return stats.rate(n, rec["window_s"])
