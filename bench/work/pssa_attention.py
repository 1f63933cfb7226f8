"""Operations and bytes of the PSSA self-attention launches over the
profiled rounds, on a basis no implementation can beat:

* operations: the score product Q K^T over every (query, key) pair (the
  pruning needs every score), and the product P V over the kept scores
  only.  The kept share is the cond rows' own, from the program's
  counters; the uncond rows are taken at the cond rows' share.  Rated at
  the card's dense bf16 tensor-core peak, the highest a float attention
  could use;
* bytes: q, k, v read once and the output written once at 2 bytes an
  element (bf16, the type of that rate), the two per-query counters
  written once at 2 bytes (they count at most 4096 keys).

The slot step runs every slot's row, occupied or not; the first block's
self-attention runs on the cond half alone (both halves are equal there).
"""
import peaks
from reference import sampling


def work(run):
    unet = run.model["unet"]
    layers = sampling.family(run.model["family"]).attention_layers(unet)
    heads, slots = unet["num_heads"], run.slots
    counters = run.profiled_counters()            # (R, S, L, 3)
    steps = counters.shape[0]
    ops = nbytes = 0.0
    for i, (res, c) in enumerate(layers):
        t, d = res * res, c // heads
        rows = slots if i == 0 else 2 * slots
        kept = float(counters[:, :, i, 0].sum()) / (steps * slots * heads
                                                   * t * t)
        qk = 2.0 * steps * rows * heads * t * t * d
        ops += qk * (1.0 + kept)
        nbytes += steps * rows * heads * t * (4 * d * 2 + 2 * 2)
    return ops, nbytes, peaks.BF16_FLOPS
