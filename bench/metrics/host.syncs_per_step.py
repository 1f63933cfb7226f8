"""Host synchronisations (stream, device and event synchronise calls and
blocking copies) per router round over the profiled rounds."""


def read(run):
    if run.reduced is None or not run.rec.prof_rounds:
        return None
    lo, hi = run.rec.prof_rounds
    return run.reduced.syncs / (hi - lo) if hi > lo else None
