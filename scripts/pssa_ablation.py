#!/usr/bin/env python3
"""What holds the PSSA attention kernel back: an ablation on the card.

    python3 scripts/pssa_ablation.py [--reps 10]

Builds variants of ``src/repro_torch/csrc/pssa_attention.cu``, each with
one part of the kernel removed by a text substitution, and times each at the
main path's largest shape, (BH, T, d) = (16, 4096, 40), with the inputs
rotated past the L2 (``chip_smoke.rotating_ms``), in the order listed and
then reversed.  The variants compute wrong results by design: only their
times are read.  Needs one CUDA card and nvcc; prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "pssa_attention.cu"
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


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def build(tmp: pathlib.Path) -> dict:
    """One shared library per variant, only the d = 40 instantiation."""
    from repro_torch.kernels import build as kbuild
    src = SRC.read_text()
    if DISPATCH not in src:
        raise SystemExit("pssa_ablation: the kernel's dispatch list changed")
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src.replace(DISPATCH, "  PSSA_CASE(5)")
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"pssa_ablation: {name}: the kernel no "
                                 f"longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.ARCH_FLAGS, *kbuild.NVCC_FLAGS, "-shared",
             "-Xptxas", "-v", str(cu), "-o", str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"pssa_ablation: {name} does not build:\n{out}")
        regs = [line.split("Used")[1].split(",")[0].strip()
                for line in out.splitlines() if "Used" in line]
        print(f"{name}: removes {VARIANTS[name][0]}; {', '.join(regs)}",
              flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.launch_pssa_attention.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                              I, I, F, F, P]
        lib.launch_pssa_attention.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pssa_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    print(smi(), flush=True)
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
                1.0 / math.sqrt(d), chip_smoke.THRESHOLD, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return run

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(chip_smoke.rotating_ms(
                    torch, launcher(libs[name]), sets, reps=args.reps))
    base = sum(times["kernel"]) / 2
    print(f"shape (BH, Tq, Tk, d, patch) = {SHAPE}, ms (two runs), "
          f"saving against the kernel")
    for name, ts in times.items():
        mean = sum(ts) / 2
        print(f"  {name:16s} {ts[0]:.4f} {ts[1]:.4f}  saves "
              f"{base - mean:+.4f} ms ({(base - mean) / base:+.1%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
