"""Public op: PSXU bitmap / patch-XOR / popcount over leading axes (port
of ``repro.kernels.patch_bitmap.ops``).

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain PyTorch version; the op is row-independent, so leading axes
fold into rows and no padding is needed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.patch_bitmap.kernel import (BLOCK_ROWS_CHOICES,
                                                     check_block_rows,
                                                     patch_bitmap_kernel)
from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref


def patch_bitmap(sas: torch.Tensor, patch: int, threshold: float,
                 use_kernel: bool = True, br: int | None = None):
    """(..., Tq, Tk) SAS -> packed XOR bitmap (..., Tq, Tk/32) uint32 and
    per-patch popcounts (..., Tq, Tk/patch) int32.  ``use_kernel`` False
    takes the plain version on any device.  ``br`` is the kernel's rows a
    block (``kernel.check_block_rows``; ``None``: 8); it moves no bit, and
    the plain version has none."""
    check_block_rows(br)
    *lead, tq, tk = sas.shape
    flat = sas.reshape(-1, tk)
    if use_kernel and sas.is_cuda:
        packed, counts = patch_bitmap_kernel(
            flat.to(torch.float32).contiguous(), patch, threshold, br=br)
    else:
        packed, counts = patch_bitmap_ref(flat, patch, threshold)
    return (packed.reshape(*lead, tq, tk // 32),
            counts.reshape(*lead, tq, tk // patch))


# ---------------------------------------------------------------------------
# Autotune hooks (repro_torch.kernels.autotune): geometry = (rows, tk, patch)
# ---------------------------------------------------------------------------
AUTOTUNE_KNOBS = ("bitmap_block_rows",)
_PROBE_THRESHOLD = 1.0 / 8192.0       # the paper's PSSA operating point


def autotune_candidates(geom: tuple) -> tuple:
    """Every rows-a-block the kernel takes (one warp a row), 8 (its
    launch rule) among them."""
    return tuple({"bitmap_block_rows": s} for s in BLOCK_ROWS_CHOICES)


def autotune_probe(geom: tuple, blocks: dict, *, device=None):
    """(fn, input sets) the autotuner times for one block config."""
    rows, tk, patch = geom
    dev = runtime.resolve_device(device)
    n = runtime.rotation(4 * rows * tk, dev)
    sas = torch.rand((n, rows, tk), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    sas *= 2e-4

    def fn(s):
        return patch_bitmap(s, patch, _PROBE_THRESHOLD,
                            br=blocks["bitmap_block_rows"])
    return fn, [(sas[i],) for i in range(n)]
