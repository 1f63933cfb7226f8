"""Peak device memory allocated over set-up and window (10^9 bytes),
read before the reference runs."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
