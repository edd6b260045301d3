"""The engine's ``sched.slot_occupancy`` histogram over the traced slice:
live slots over ``max_slots`` at each decode dispatch, as a mean, in %."""
from bench.lib.slicework import serve_slice


def read(rec):
    sl = serve_slice(rec)
    if sl is None or not sl["counters"]["occupancy_n"]:
        return None
    c = sl["counters"]
    return 100.0 * c["occupancy_sum"] / c["occupancy_n"]
