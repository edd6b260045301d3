"""``bc_grad_w``'s share of its roofline in the traced training steps:
the least time of every circulant projection's weight gradient over B x S
rows once a step (``chip_smoke.py:grad_w_work``'s count, copied in
``lib/work.py``), over the device time of the kernels below, in %."""
from bench.lib import work
from bench.lib.slicework import device_s, train_slice

KERNELS = ("dft_kernel", "dft_any_kernel", "mac_kernel", "idft_kernel")


def read(rec):
    sl = train_slice(rec)
    t = device_s(sl, KERNELS) if sl is not None else 0.0
    if t <= 0:
        return None
    cfg, mix, pk = rec["cfg"], rec["mix"], work.peaks()
    N = mix["batch"] * mix["seq"]
    least = cfg["num_hidden_layers"] * sum(
        work.least_s(*work.bc_grad_w(N, p, q, k), pk)
        for p, q, k in work.layer_shapes(cfg))
    return 100.0 * least * sl["steps"] / t
