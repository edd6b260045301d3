"""The 90th percentile, over every request whose first token falls in the
window, of the milliseconds from the client's submit (an open loop: from
when it was due) to that token; a request that failed or was refused in
the window counts as missing (infinite)."""
from bench.lib import stats


def read(rec):
    if rec.get("kind") != "serve":
        return None
    xs = stats.ttft_samples(rec["tracks"], rec["t_open"], rec["t_close"])
    return 1e3 * stats.percentile(xs, 90) if xs else None
