"""``bc_fused``'s share of its roofline in the traced slice: the least time
of every circulant projection on the rows the traffic needs (true prompt
tokens; live decode slots) over the device time of the kernels below, in
%."""
from bench.lib import work
from bench.lib.slicework import bc_fused_least_s, device_s, serve_slice

KERNELS = ("bc_fused_kernel",)


def read(rec):
    sl = serve_slice(rec)
    t = device_s(sl, KERNELS) if sl is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * bc_fused_least_s(rec["cfg"], sl["steps"],
                                    work.peaks()) / t
