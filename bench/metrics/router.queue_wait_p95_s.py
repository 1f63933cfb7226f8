"""95th percentile of arrival-to-admission seconds over the requests that
arrived in the window before the profiler was started (starting and
stopping it hold admission), never admitted: the time the run waited."""
import numpy as np


def read(run):
    stop = max([r["admitted_s"] or 0.0 for r in run.requests]
               + [run.window[1]])
    cut = run.window[1]
    if run.rec.prof_span is not None:
        cut = min(cut, run.rec.prof_armed_at - run.t0)
    waits = [(r["admitted_s"] if r["admitted_s"] is not None else stop)
             - r["arrival_s"] for r in run.counted if r["arrival_s"] < cut]
    return float(np.percentile(waits, 95)) if waits else None
