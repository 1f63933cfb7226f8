"""Share (%) of the profiled rounds' wall time in which no operation ran
on the device (1 - the union of device intervals / the span)."""


def read(run):
    r = run.reduced
    if r is None or r.span_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.span_s)
