"""Microseconds of prefill (``make_prefill_pack_step``, B = 1) a true
prompt token over the traced slice: the engine's ``prefill_s`` over the
prompt tokens it prefilled."""
from bench.lib.slicework import serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or not sl["counters"]["prompt_tokens"]:
        return None
    c = sl["counters"]
    return 1e6 * c["prefill_s"] / c["prompt_tokens"]
