#!/usr/bin/env python3
"""What holds the PSSA attention kernel back: an ablation on the card.

    python3 scripts/pssa_ablation.py [--reps 10]

Builds variants of ``src/repro_torch/csrc/pssa_attention.cu``, each with
one part of the kernel removed by a text substitution, and times each at the
main path's largest shape, (BH, T, d) = (16, 4096, 40), with the inputs
rotated past the L2 (``chip_smoke.rotating_ms``), in the order listed and
then reversed; a variant's time is the mean of the two
(``scripts/kernel_ablation.py``).  The variants compute wrong results by
design: only their times are read.  Needs one CUDA card and nvcc; prints the
card's name and power limit first.
"""
from __future__ import annotations

import math
import sys

import kernel_ablation as ka

SRC = ka.ROOT / "src" / "repro_torch" / "csrc" / "pssa_attention.cu"
SHAPE = (16, 4096, 4096, 40, 64)            # BH, Tq, Tk, d, patch
DISPATCH = ("  PSSA_CASE(1) PSSA_CASE(2) PSSA_CASE(3) PSSA_CASE(4) "
            "PSSA_CASE(5)\n  PSSA_CASE(6) PSSA_CASE(8) PSSA_CASE(10) "
            "PSSA_CASE(12) PSSA_CASE(16)\n  PSSA_CASE(20)")

# name -> (what is removed, [(text, replacement)])
VARIANTS = {
    "kernel": ("nothing", []),
    "no_small_mma": (
        "the two small-term MMAs of every 3xTF32 product (and so the small "
        "halves' splits)",
        [("  mma(d, as, bb[0], bb[1]);\n  mma(d, ab, bs[0], bs[1]);\n", "")]),
    "no_pv": (
        "the P.V MMAs (and so the V fragments and P's split)",
        [("          mma3_step(o[c], ab, as, bb, bs);\n", "")]),
    "no_counters": (
        "the keep bits and both popcounts",
        [("          if (kp) w[e >> 1][j >> 2] |= 1u << (8 * (j & 3) + (e & 1));\n",
          ""),
         ("        nnz[h] += __popcll(bits);\n", ""),
         ("        xr[h] += __popcll((bits ^ left) & valid_mask);\n", "")]),
    "no_band": (
        "the guard band's recompute",
        [("      if (__any_sync(FULL, bmask != 0)) {",
          "      if (false) {")]),
    "no_exp_pass1": (
        "pass 1's exponentials (the scores summed as they are)",
        [("          sum += ex2_approx((s[j][2 * h] - m[h]) * LOG2E) +\n"
          "                 ex2_approx((s[j][2 * h + 1] - m[h]) * LOG2E);",
          "          sum += s[j][2 * h] + s[j][2 * h + 1];")]),
    "no_split_alu": (
        "split()'s arithmetic (big = x, small = 0; the MMAs still run)",
        [("  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));",
          "  big = __float_as_uint(x);\n  small = 0u;")]),
    "rna_pass2_qk": (
        "pass 2's cheaper QK^T split (split() there too)",
        [("  big = __float_as_uint(x) & 0xffffe000u;\n"
          "  small = __float_as_uint(x - __uint_as_float(big));",
          "  split(x, big, small);")]),
    "running_pv": (
        "P.V's per-step sums (the output carried in the accumulator)",
        [("          mma3_step(o[c], ab, as, bb, bs);",
          "          mma3(o[c], ab, as, bb, bs);")]),
    "running_pass1": (
        "pass 1's per-step sums (its scores carried in the accumulator)",
        [("          mma3_step(s[j], ab, as, bb, bs);",
          "          mma3(s[j], ab, as, bb, bs);")]),
}



def setup(torch, chip_smoke):
    """Input sets at the main path's largest shape, and a launcher."""
    bh, tq, tk, d, patch = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    sets = [tuple(torch.randn((bh, t, d), generator=g, device="cuda")
                  for t in (tq, tk, tk))
            for _ in range(math.ceil(2 * chip_smoke.L2_BYTES
                                     / (4 * d * bh * (tq + 2 * tk))))]
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        def run(q, k, v):
            out = torch.empty_like(q)
            nnz = torch.empty((bh, tq), dtype=torch.int32, device="cuda")
            xr = torch.empty_like(nnz)
            err = lib.launch_pssa_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                nnz.data_ptr(), xr.data_ptr(), bh, tq, tk, tk, d, patch,
                1.0 / math.sqrt(d), chip_smoke.THRESHOLD, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return run
    return [(f"(BH, Tq, Tk, d, patch) = {SHAPE}", sets, launcher)]


if __name__ == "__main__":
    # only the d = 40 instantiation is built
    sys.exit(ka.main(
        tag="pssa_ablation", doc=__doc__, src=SRC, variants=VARIANTS,
        names=["launch_pssa_attention"], setup=setup, rounds=2,
        common=[(DISPATCH, "  PSSA_CASE(5)")],
        labels={"pssa_attention_kernel": "pssa"}))
