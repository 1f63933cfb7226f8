"""Share (%) of the roofline bound in the PSSA kernel's device time over
the profiled rounds (operations and bytes: work/pssa_attention.py)."""


def read(run):
    return run.kernel_roofline("pssa_attention")
