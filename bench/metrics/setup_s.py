"""Seconds from the start of the process until the window opens: imports,
building the kernels where they are not built, weights, the engine or the
training step, warm-up and the ramp of load before the window."""


def read(rec):
    return rec.get("setup_s")
