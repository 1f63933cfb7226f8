"""Operations and bytes of the DBSC bit-slice FFN launches over the
profiled rounds, on a basis no implementation can beat:

* operations: the high 6-bit plane times the INT8 weights for every row,
  and the low plane for the rows that keep INT12: in the GEGLU matmul the
  TIPS-important tokens (the cond rows' counts from the program's
  counters, the uncond rows taken alike; rows outside the TIPS window,
  which keep INT12 too, are not counted, so this is a lower bound), in
  the output matmul every row.  Rated at the card's dense int8 peak;
* bytes: each activation's 12-bit code read once at 1.5 bytes, each INT8
  weight once, each int32 accumulator written once, one bit a row for the
  precision flag.

Both matmuls of every block's FFN run on all 2 x slots rows.
"""
import peaks
from reference import sampling


def _matmul(m, m_lo, k, n):
    ops = 2.0 * k * n * (m + m_lo)
    nbytes = 1.5 * m * k + k * n + 4.0 * m * n + m / 8.0
    return ops, nbytes


def work(run):
    unet = run.model["unet"]
    layers = sampling.family(run.model["family"]).attention_layers(unet)
    mult, slots = unet["ffn_mult"], run.slots
    counters = run.profiled_counters()            # (R, S, L, 3)
    steps = counters.shape[0]
    ops = nbytes = 0.0
    for i, (res, c) in enumerate(layers):
        m = steps * 2 * slots * res * res
        important = 2.0 * float(counters[:, :, i, 2].sum())
        for o, b in (_matmul(m, important, c, 2 * mult * c),
                     _matmul(m, m, mult * c, c)):
            ops, nbytes = ops + o, nbytes + b
    return ops, nbytes, peaks.INT8_OPS
