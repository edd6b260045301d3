"""``bc_fused``'s share of its roofline in the traced training steps: the
least time of every circulant projection's forward (B x S rows against
its p x q planes) and its input gradient (the adjoint, q x p) once a
step, over the device time of the kernels below (which also hold the
forward the remat policy runs again), in %."""
from bench.lib import work
from bench.lib.slicework import device_s, train_slice

KERNELS = ("bc_fused_kernel",)


def read(rec):
    sl = train_slice(rec)
    t = device_s(sl, KERNELS) if sl is not None else 0.0
    if t <= 0:
        return None
    cfg, mix, pk = rec["cfg"], rec["mix"], work.peaks()
    N = mix["batch"] * mix["seq"]
    least = cfg["num_hidden_layers"] * sum(
        work.least_s(*work.bc_fused(N, p, q, k), pk)
        + work.least_s(*work.bc_fused(N, q, p, k), pk)
        for p, q, k in work.layer_shapes(cfg))
    return 100.0 * least * sl["steps"] / t
