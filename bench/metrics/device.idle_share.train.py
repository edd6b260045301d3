"""The share of the traced training steps' wall time in which nothing ran
on the device, from ``torch.profiler``, in %."""
from bench.lib.slicework import train_slice


def read(rec):
    sl = train_slice(rec)
    if sl is None or sl["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["slice_s"])
