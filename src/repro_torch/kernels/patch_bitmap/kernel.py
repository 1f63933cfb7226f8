"""Launch wrapper of the hand-written PSXU patch-bitmap kernel
(``csrc/patch_bitmap.cu``; replaces the TPU kernel
``repro/kernels/patch_bitmap/kernel.py: patch_bitmap_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("patch_bitmap")
# patches the kernel takes: divisors of 32, or 32 times a power of two
PATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
# rows a block the kernel takes, one warp each (``None``: 8)
BLOCK_ROWS_CHOICES = (2, 4, 8, 16, 32)


def check_block_rows(br) -> None:
    """Raise unless ``br`` is ``None`` or one of ``BLOCK_ROWS_CHOICES``;
    a value is never clamped."""
    if br is not None and br not in BLOCK_ROWS_CHOICES:
        raise ValueError(f"patch_bitmap: block_rows={br!r}, expected None "
                         f"or one of {BLOCK_ROWS_CHOICES}")


def patch_bitmap_kernel(sas: torch.Tensor, patch: int, threshold: float,
                        br: int | None = None):
    """(R, Tk) float32 SAS on the card -> (packed (R, Tk/32) uint32,
    counts (R, Tk/patch) int32); ``br`` rows a block (``None``: 8) moves
    no bit of the result.  Launches the CUDA kernel or raises."""
    check_block_rows(br)
    if not sas.is_cuda:
        raise ValueError("patch_bitmap: sas must be a CUDA tensor")
    if sas.dtype != torch.float32 or sas.ndim != 2:
        raise ValueError(f"patch_bitmap: sas must be a 2-D float32 tensor, "
                         f"got {sas.dtype} {tuple(sas.shape)}")
    if not sas.is_contiguous():
        raise ValueError("patch_bitmap: sas must be contiguous")
    rows, tk = sas.shape
    if patch not in PATCHES or tk % 32 or tk % patch:
        raise ValueError(f"patch_bitmap: patch {patch} must be one of "
                         f"{PATCHES} and divide Tk={tk}, a multiple of 32")
    lib = build.library()
    packed = torch.empty((rows, tk // 32), dtype=torch.uint32,
                         device=sas.device)
    counts = torch.empty((rows, tk // patch), dtype=torch.int32,
                         device=sas.device)
    stream = torch.cuda.current_stream(sas.device).cuda_stream
    err = lib.launch_patch_bitmap(sas.data_ptr(), packed.data_ptr(),
                                  counts.data_ptr(), rows, tk, patch,
                                  threshold, br or 0, stream)
    build.check(err, "patch_bitmap")
    LAUNCHES.bump()
    return packed, counts
