#!/usr/bin/env python3
"""What holds the TIPS cross-attention kernel back: an ablation on the card.

    python3 scripts/cross_ablation.py [--reps 10]
    python3 scripts/cross_ablation.py --fp32-kernel <file>

Builds variants of ``src/repro_torch/csrc/cross_attention_tips.cu`` (or, with
``--fp32-kernel <file>``, of the fp32 CUDA-core kernel that the tensor-core one
replaced, from a checkout of an earlier commit), each with one part of the
kernel removed by a text substitution, and times each at the main path's three
shapes, (BH, Tq, Tk, d) = (16, 4096, 77, 40), (16, 1024, 77, 80) and (16, 256,
77, 160), with the inputs rotated past the L2 (``chip_smoke.rotating_ms``), in
the order listed and then reversed; a variant's time is the median of its runs
(``scripts/kernel_ablation.py``).  A fourth case times res 64 on one input set,
so that it stays in the L2, as the fp32 kernel's rows once were timed.  The
variants compute wrong results by design: only their times are read.  Needs one
CUDA card and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import sys

import kernel_ablation as ka

SRC = ka.ROOT / "src" / "repro_torch" / "csrc" / "cross_attention_tips.cu"
SHAPES = {"res64": (16, 4096, 77, 40), "res32": (16, 1024, 77, 80),
          "res16": (16, 256, 77, 160)}
CLS_KEY_SCALE = 2.5

DISPATCH = ("  CROSS_CASE(1) CROSS_CASE(2) CROSS_CASE(3) CROSS_CASE(4) "
            "CROSS_CASE(5)\n  CROSS_CASE(6) CROSS_CASE(8) CROSS_CASE(10) "
            "CROSS_CASE(12) CROSS_CASE(16)\n  CROSS_CASE(20)")

# The 3xTF32 tensor-core kernel: name -> (what is removed or changed,
# [(text, replacement)])
VARIANTS = {
    "kernel": ("nothing", []),
    "no_small_mma": (
        "the two small-term MMAs of every 3xTF32 product",
        [("  mma(d, as, bb[0], bb[1]);\n  mma(d, ab, bs[0], bs[1]);\n", "")]),
    "no_qk_mma": (
        "the QK^T MMAs (and so the K fragments' reads and Q's split)",
        [("      mma3_step(s[j], ab, as, bb, bs);\n", "")]),
    "no_pv_mma": (
        "the P.V MMAs (and so the V fragments' reads and P's split)",
        [("      mma3_step(o[c], ab, as, bb, bs);\n", "")]),
    "no_softmax_math": (
        "the softmax's arithmetic: the scale by 1/sqrt(d), the exps and "
        "the scale by 1/sum (the max and sum shuffles stay)",
        [("s[j][2 * h + c] * inv_denom", "s[j][2 * h + c]"),
         ("expf(s[j][2 * h + c] - mx)", "(s[j][2 * h + c] - mx)"),
         ("const float p = s[j][2 * h + c] * inv_sum;",
          "const float p = s[j][2 * h + c];")]),
    "no_stripe_load": (
        "the K/V stripe's cp.async copies into shared memory",
        [("  load_stripe<DP, LK>(Kt, kb, ks_.t, TKP, tk, d, kvec, tid, "
          "nthreads);\n  load_stripe<DP, LV>(Vt, vb, vs.t, TKP, tk, d, kvec, "
          "tid, nthreads);\n", "")]),
    "no_stripe_split": (
        "the block's split of the stripe into big and small halves",
        [("    split_stripe<DP, LK>(Kt, Ksm, TKP, tid, nthreads);\n"
          "    split_stripe<DP, LV>(Vt, Vsm, TKP, tid, nthreads);\n", "")]),
    "no_q_loads": (
        "the Q rows' loads from global memory (ones instead)",
        [("__ldg(reinterpret_cast<const float2*>(pa + c))",
          "make_float2(1.f, 1.f)"),
         ("__ldg(reinterpret_cast<const float2*>(pb + c))",
          "make_float2(1.f, 1.f)")]),
    "no_stores": (
        "the stores of out and cas (kept behind a test that never holds)",
        [("          if (col < d)\n            *reinterpret_cast<float2*>",
          "          if (col < d && o[c][2 * h] == 1.2345e-30f)\n"
          "            *reinterpret_cast<float2*>"),
         ("if (mine && c0 == 0 && row < tq) cas[",
          "if (mine && c0 == 0 && row < tq && cv == 1.2345e-30f) cas[")]),
    "running_sums": (
        "the per-step sums (every product carried in the accumulator)",
        [("mma3_step(s[j], ab, as, bb, bs);", "mma3(s[j], ab, as, bb, bs);"),
         ("mma3_step(o[c], ab, as, bb, bs);", "mma3(o[c], ab, as, bb, bs);")]),
    "max_4_warps": (
        "the 8-warp blocks (blocks of up to 4 warps, 64 rows: each stripe "
        "copied and split for half the rows)",
        [("constexpr int MAX_WARPS = 8;", "constexpr int MAX_WARPS = 4;")]),
    "running_qk": (
        "QK^T's per-step sums (its scores carried in the accumulator)",
        [("mma3_step(s[j], ab, as, bb, bs);", "mma3(s[j], ab, as, bb, bs);")]),
    "no_half_ulp": (
        "the half-ulp correction of each step's sum",
        [("d[e] += plus_half_ulp(t[e]);", "d[e] += t[e];")]),
    "no_d_split": (
        "the split of d over a block's 4 warps from d = 96 on (res 16: 256 "
        "blocks of 1 warp over all of d instead of 256 of 4)",
        [("(KS >= 12 ? 4 : 1)", "1")]),
}

# The fp32 CUDA-core kernel that this one replaced: name -> (what is
# removed, [(text, replacement)])
FP32_VARIANTS = {
    "kernel": ("nothing", []),
    "no_loads": (
        "the Q tile's and the K/V stripe's loads into shared memory",
        [("    Qs[r * ld + c] = row < tq ? qb[(size_t)row * d + c] : 0.f;\n",
          "    (void)row;\n"),
         ("    Ks[r * ld + c] = in ? kb[i] : 0.f;\n"
          "    Vs[i] = in ? vb[i] : 0.f;\n",
          "    (void)in;\n")]),
    "no_qk": (
        "the QK^T loop",
        [("  for (int c = 0; c < d; ++c) {\n    float qv[4];",
          "  for (int c = 0; c < 0; ++c) {\n    float qv[4];")]),
    "no_softmax": (
        "the softmax: the scale, row max, exps, row sum and divide",
        [("s[i][j] = (tx + 16 * j < tk) ? s[i][j] / sm_denom : NEG_INF;",
          "s[i][j] = (tx + 16 * j < tk) ? s[i][j] : NEG_INF;"),
         ("    mx = half_warp_max(mx);\n", ""),
         ("        s[i][j] = expf(s[i][j] - mx);       "
          "// masked keys: exactly 0\n",
          ""),
         ("    sum = half_warp_sum(sum);\n", ""),
         ("        const float p = s[i][j] / sum;\n",
          "        const float p = s[i][j];\n")]),
    "no_pv": (
        "the P.V loop",
        [("  for (int jj = 0; jj < tk; ++jj) {",
          "  for (int jj = 0; jj < 0; ++jj) {")]),
    "no_stores": (
        "the stores of out and cas (kept behind a test that never holds)",
        [("        if (col < d) out[",
          "        if (col < d && acc[i][c] == 1.2345e-30f) out["),
         ("        if (key == cls_index && q0 + r < tq)",
          "        if (key == cls_index && q0 + r < tq && "
          "p == 1.2345e-30f)")]),
}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# q, k, v, out, cas, bh, tq, tk, d, cls_index, sm_denom, stream
FP32_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


def setup_for(fp32: bool):
    def setup(torch, chip_smoke):
        """Input sets at the three main shapes (and res 64 on one set),
        and a launcher of one variant for each."""
        g = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        cases = []
        for label, (bh, tq, tk, d) in SHAPES.items():
            sets = []
            for _ in range(math.ceil(2 * chip_smoke.L2_BYTES
                                     / (4 * d * bh * (tq + 2 * tk)))):
                q = torch.randn((bh, tq, d), generator=g, device="cuda")
                k, v = (torch.randn((bh, tk, d), generator=g, device="cuda")
                        for _ in range(2))
                k[:, 0] *= CLS_KEY_SCALE
                sets.append((q, k, v))

            def launcher(lib, bh=bh, tq=tq, tk=tk, d=d):
                fn = lib.launch_cross_attention_tips
                if fp32:
                    fn.argtypes = FP32_SIGNATURE

                def run(q, k, v):
                    out = torch.empty_like(q)
                    cas = torch.empty((bh, tq), device="cuda")
                    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), cas.data_ptr())
                    if fp32:
                        err = fn(*ptrs, bh, tq, tk, d, 0, float(d) ** 0.5,
                                 stream)
                    else:
                        err = fn(*ptrs, bh, 1, tq, tk, d, 0, float(d) ** 0.5,
                                 tq * d, 0, d, tk * d, 0, d, tk * d, 0, d,
                                 tq * d, 0, d, 0, stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                return run
            cases.append((f"{label} (BH, Tq, Tk, d) = {(bh, tq, tk, d)}",
                          sets, launcher))
            if label == "res64":
                cases.append((f"{label} on one input set (L2-warm)",
                              sets[:1], launcher))
        return cases
    return setup


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--fp32-kernel", type=pathlib.Path, default=None)
    own, rest = ap.parse_known_args()
    fp32 = own.fp32_kernel is not None
    sys.exit(ka.main(
        tag="cross_ablation", doc=__doc__,
        src=own.fp32_kernel.resolve() if fp32 else SRC,
        variants=FP32_VARIANTS if fp32 else VARIANTS,
        names=["launch_cross_attention_tips"], setup=setup_for(fp32),
        rounds=2, argv=rest,
        common=() if fp32 else [(DISPATCH, "  CROSS_CASE(5) CROSS_CASE(10) "
                                           "CROSS_CASE(20)")],
        labels={"cross_attention_tips_kernel": "cross"}))
