"""The model's operations in the traced slice (``slicework.model_flops``:
true prompt tokens and decoded tokens through the circulant projections as
the algorithm needs them, attention at each token's context, the tied
head once a token emitted) over the slice's seconds at the peak rate, in
%."""
from bench.lib import work
from bench.lib.slicework import model_flops, serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or not sl["steps"]:
        return None
    flops = model_flops(rec["cfg"], sl["steps"])
    return 100.0 * flops / (sl["slice_s"] * work.peaks()["flops_per_s"])
