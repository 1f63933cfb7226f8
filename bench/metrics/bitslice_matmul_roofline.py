"""Share (%) of the roofline bound in the DBSC bit-slice kernel's device
time over the profiled rounds (work/bitslice_matmul.py)."""


def read(run):
    return run.kernel_roofline("bitslice_matmul")
