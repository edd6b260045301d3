"""The prefill flash attention's share of its roofline in the traced
slice: causal score and AV operations on the true prompt tokens, with Q,
K, V and O (bf16) once, per layer, over the device time of the kernels
below, in %."""
from bench.lib import work
from bench.lib.slicework import device_s, flash_least_s, serve_slice

KERNELS = ("flash_bf16_kernel", "flash_combine")


def read(rec):
    sl = serve_slice(rec)
    t = device_s(sl, KERNELS) if sl is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * flash_least_s(rec["cfg"], sl["steps"], work.peaks(),
                                 2) / t
