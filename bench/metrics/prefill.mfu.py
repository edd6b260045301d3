"""The prefills' share of the chip's peak over the traced slice: the
model's operations in them (``slicework.prefill_flops``) over the engine's
prefill seconds (``prefill_s``) at the peak rate, in %."""
from bench.lib import work
from bench.lib.slicework import prefill_flops, serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or sl["counters"]["prefill_s"] <= 0:
        return None
    flops = prefill_flops(rec["cfg"], sl["steps"])
    return 100.0 * flops / (sl["counters"]["prefill_s"]
                            * work.peaks()["flops_per_s"])
