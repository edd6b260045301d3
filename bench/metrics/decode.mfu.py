"""The decode steps' share of the chip's peak over the traced slice: the
model's operations in them (``slicework.decode_flops``: live slots only)
over the engine's decode seconds (``decode_s``) at the peak rate, in %."""
from bench.lib import work
from bench.lib.slicework import decode_flops, serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or sl["counters"]["decode_s"] <= 0:
        return None
    flops = decode_flops(rec["cfg"], sl["steps"])
    return 100.0 * flops / (sl["counters"]["decode_s"]
                            * work.peaks()["flops_per_s"])
