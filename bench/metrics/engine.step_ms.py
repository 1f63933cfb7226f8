"""Mean milliseconds of one ``slot_step`` (the engine's own synchronised
wall time) over the window's rounds outside the profiled ones."""


def read(run):
    walls = [run.rec.rounds[i][2] for i in run.window_rounds()]
    return 1e3 * sum(walls) / len(walls) if walls else None
