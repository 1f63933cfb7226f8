"""Seconds from the process start to the window's start: imports, the
weights, the engine, the kernel build or load, the warm-up and the ramp
of the mix to its steady state."""


def read(run):
    return run.setup_s
