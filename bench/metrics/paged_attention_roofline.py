"""The paged decode attention's share of its roofline in the traced slice:
the K/V of every live position at the pool's width (bf16), plus each live
slot's query and output (bf16), per layer and step, over the device time
of the kernels below, in %."""
from bench.lib import work
from bench.lib.slicework import device_s, paged_least_s, serve_slice

KERNELS = ("paged_kernel", "paged_combine")
ITEMSIZE = {"bf16": 2, "f32": 4, "int8": 1}


def read(rec):
    sl = serve_slice(rec)
    t = device_s(sl, KERNELS) if sl is not None else 0.0
    if t <= 0:
        return None
    kv = ITEMSIZE[rec["mix"]["engine"]["kv_dtype"]]
    return 100.0 * paged_least_s(rec["cfg"], sl["steps"], work.peaks(),
                                 2, kv) / t
