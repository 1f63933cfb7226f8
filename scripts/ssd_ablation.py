#!/usr/bin/env python3
"""What holds the SSD scan kernel back: an ablation on the card.

    python3 scripts/ssd_ablation.py [--reps 10]

Builds variants of ``src/repro_torch/csrc/ssd_scan.cu``, each with one part
of the kernel removed by a text substitution, and times each at the serve
shape, (b, heads, T, p, n, chunk) = (4, 24, 4096, 64, 128, 128), with the
inputs rotated past the L2 (``chip_smoke.rotating_ms``), in the order
listed, reversed, then listed again; each variant's median of the three
is its time (``scripts/kernel_ablation.py``).  The variants compute wrong
results by design: only their times are read.  Prints each kernel's
registers and spills (``-Xptxas -v``).  Needs one CUDA card and nvcc;
prints the card's name and power limit first.
"""
from __future__ import annotations

import math
import sys

import kernel_ablation as ka

SRC = ka.ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
SHAPE = (4, 24, 4096, 64, 128, 128)         # b, heads, T, p, n, chunk

# name -> (what is removed, [(text, replacement)])
VARIANTS = {
    "kernel": ("nothing", []),
    "no_phase_a": (
        "phase A (each chunk's own state and decay)",
        [("  if (nchunks > 0) {\n    const size_t bytes = (size_t)smem_a(D)",
          "  if (false) {\n    const size_t bytes = (size_t)smem_a(D)")]),
    "no_phase_b": (
        "phase B (the state pass over the chunks)",
        [("    ssd_scan_kernel_pass<float4><<<",
          "    if (false) ssd_scan_kernel_pass<float4><<<"),
         ("    ssd_scan_kernel_pass<float><<<",
          "    if (false) ssd_scan_kernel_pass<float><<<")]),
    "no_phase_g": (
        "phase G (C B^T, once per batch row and chunk)",
        [("    ssd_scan_kernel_cbt<<<",
          "    if (false) ssd_scan_kernel_cbt<<<")]),
    "no_phase_c": (
        "phase C (y)",
        [("    ssd_scan_kernel_out<<<",
          "    if (false) ssd_scan_kernel_out<<<")]),
    "no_cbt_reads": (
        "phase C's reads of C B^T from the L2 (ones instead)",
        [("    const float2 ga = __ldg(reinterpret_cast<const float2*>"
          "(g0 + k));",
          "    const float2 ga = make_float2(1.f, 1.f);"),
         ("    const float2 gb = __ldg(reinterpret_cast<const float2*>"
          "(g0 + 8 * lr + k));",
          "    const float2 gb = make_float2(1.f, 1.f);")]),
    "no_state_product": (
        "phase C's C state_in^T (its C reads, MMAs and decay)",
        [("  if (carry) {\n    const float* cr0",
          "  if (false) {\n    const float* cr0")]),
    "no_small_mma": (
        "the two small-term MMAs of every 3xTF32 product",
        [("  mma(d, as, bb[0], bb[1]);\n  mma(d, ab, bs[0], bs[1]);\n", "")]),
    "no_scan": (
        "the warp scan's steps across lanes (each lane's own sums stay)",
        [("#pragma unroll\n  for (int off = 1; off < 32; off *= 2) {\n"
          "    const double u = __shfl_up_sync(FULL, tot, off);\n"
          "    if (lane >= off) tot += u;\n  }\n"
          "  double ex = __shfl_up_sync(FULL, tot, 1);\n"
          "  if (lane == 0) ex = 0.0;\n",
          "  double ex = tot;\n")]),
    "no_l_exp": (
        "L's exponentials (ex2.approx of each causal pair)",
        [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
          "  y = x;\n")]),
    "no_split_alu": (
        "split()'s arithmetic (big = x, small = 0; the MMAs still run)",
        [("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  small = __float_as_uint(x - __uint_as_float(big));",
          "  big = __float_as_uint(x);\n  small = 0u;")]),
}


LABELS = {"ssd_scan_kernel_state": "A", "ssd_scan_kernel_passIf": "B",
          "ssd_scan_kernel_passI6float4": "B4", "ssd_scan_kernel_cbt": "G",
          "ssd_scan_kernel_out": "C"}


def setup(torch, chip_smoke):
    """Input sets at the serve shape, and a launcher of one variant."""
    import torch.nn.functional as F
    b, heads, t, p, n, chunk = SHAPE
    bh = b * heads
    g = torch.Generator(device="cuda").manual_seed(0)
    set_bytes = 4 * (bh * t * p + bh * t + 2 * b * t * n)
    sets = []
    for _ in range(max(2, math.ceil(2 * chip_smoke.L2_BYTES / set_bytes))):
        x = torch.randn((bh, t, p), generator=g, device="cuda")
        dA = -F.softplus(torch.randn((bh, t), generator=g, device="cuda"))
        B, C = (0.3 * torch.randn((b, t, n), generator=g, device="cuda")
                for _ in range(2))
        sets.append((x, dA, B, C))
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        ws_floats = lib.ssd_scan_workspace_floats(bh, t, p, n, heads)

        def run(x, dA, B, C):
            y = torch.empty_like(x)
            state = torch.empty((bh, p, n), device="cuda")
            ws = torch.empty(ws_floats, device="cuda")
            err = lib.launch_ssd_scan(
                x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
                y.data_ptr(), state.data_ptr(), ws.data_ptr(), bh, t, p, n,
                chunk, heads, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return run
    return [(f"(b, heads, T, p, n, chunk) = {SHAPE}", sets, launcher)]


if __name__ == "__main__":
    sys.exit(ka.main(
        tag="ssd_ablation", doc=__doc__, src=SRC, variants=VARIANTS,
        names=["launch_ssd_scan", "ssd_scan_workspace_floats"], setup=setup,
        rounds=3,
        labels=LABELS))
