"""Public op: PSXU bitmap / patch-XOR / popcount over leading axes (port
of ``repro.kernels.patch_bitmap.ops``).

A CUDA tensor goes through the hand-written kernel, a CPU tensor through
the plain PyTorch version; the op is row-independent, so leading axes
fold into rows and no padding is needed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.patch_bitmap.kernel import patch_bitmap_kernel
from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref


def patch_bitmap(sas: torch.Tensor, patch: int, threshold: float,
                 use_kernel: bool = True):
    """(..., Tq, Tk) SAS -> packed XOR bitmap (..., Tq, Tk/32) uint32 and
    per-patch popcounts (..., Tq, Tk/patch) int32.  ``use_kernel`` False
    takes the plain version on any device."""
    *lead, tq, tk = sas.shape
    flat = sas.reshape(-1, tk)
    if use_kernel and sas.is_cuda:
        packed, counts = patch_bitmap_kernel(
            flat.to(torch.float32).contiguous(), patch, threshold)
    else:
        packed, counts = patch_bitmap_ref(flat, patch, threshold)
    return (packed.reshape(*lead, tq, tk // 32),
            counts.reshape(*lead, tq, tk // patch))
