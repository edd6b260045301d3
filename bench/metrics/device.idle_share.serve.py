"""The share of the traced slice's wall time in which nothing ran on the
device (no kernel, copy or set), from ``torch.profiler``, in %."""
from bench.lib.slicework import serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or sl["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["slice_s"])
