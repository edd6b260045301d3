"""The model's operations in the traced steps, forward and backward
without recomputation (three forward passes' worth: every token through
the circulant projections as the algorithm needs them, causal attention
and the tied head), over the traced seconds at the peak rate, in %."""
from bench.lib import work
from bench.lib.slicework import train_slice


def read(rec):
    sl = train_slice(rec)
    if sl is None:
        return None
    cfg, mix = rec["cfg"], rec["mix"]
    B, S = mix["batch"], mix["seq"]
    fwd = (B * S * (work.projection_flops_per_token(cfg)
                    + work.head_flops(cfg))
           + B * work.attention_flops(cfg, 1) * S * (S + 1) / 2)
    return (100.0 * 3 * fwd * sl["steps"]
            / (sl["slice_s"] * work.peaks()["flops_per_s"]))
