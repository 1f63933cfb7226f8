"""95th percentile of arrival-to-image seconds over every request that
arrived in the window.  A request that never finished counts with the
time the run waited for it, which is longer than any that finished."""
import numpy as np


def read(run):
    stop = max([r["finished_s"] or 0.0 for r in run.requests]
               + [run.window[1]])
    lats = [(r["finished_s"] if r["finished_s"] is not None else stop)
            - r["arrival_s"] for r in run.counted]
    return float(np.percentile(lats, 95)) if lats else None
