"""Of the engine's dispatch seconds in the traced slice (``stats()``'s
``prefill_s`` and ``decode_s``, host clocks each dispatch closes with a
synchronize), the share in prefill, in %."""
from bench.lib.slicework import serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None:
        return None
    c = sl["counters"]
    total = c["prefill_s"] + c["decode_s"]
    return 100.0 * c["prefill_s"] / total if total > 0 else None
