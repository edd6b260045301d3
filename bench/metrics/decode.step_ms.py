"""Milliseconds of one step of the graph-replayed paged decode loop over
the traced slice: the engine's ``decode_s`` over its decode steps."""
from bench.lib.slicework import serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or not sl["counters"]["engine.decode_steps"]:
        return None
    c = sl["counters"]
    return 1e3 * c["decode_s"] / c["engine.decode_steps"]
