"""Launch wrapper of the hand-written patch-delta kernel
(``csrc/patch_delta.cu``; replaces the TPU kernel
``repro/kernels/patch_reuse/kernel.py: patch_delta_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("patch_delta")
SLICE = 256               # values of a patch row in one slice
# slices of one patch row a block takes (``None``: 8, 2048 values)
BLOCK_SLICES_CHOICES = (2, 4, 8, 16, 32)


def check_block_slices(bp) -> None:
    """Raise unless ``bp`` is ``None`` or one of ``BLOCK_SLICES_CHOICES``;
    a value is never clamped."""
    if bp is not None and bp not in BLOCK_SLICES_CHOICES:
        raise ValueError(f"patch_delta: block_slices={bp!r}, expected None "
                         f"or one of {BLOCK_SLICES_CHOICES}")


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"patch_delta: {name} must be a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"patch_delta: {name} must be float32, "
                         f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"patch_delta: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"patch_delta: {name} must be contiguous")


def patch_delta_kernel(xf: torch.Tensor, rf: torch.Tensor,
                       bp: int | None = None) -> torch.Tensor:
    """(B, P, patch*C) folded tokens and reference on the card -> (B, P)
    float32 max-abs delta.  ``bp``: slices of ``SLICE`` values of one patch
    row a block takes (``None``: 8); max is order-free, so it moves no bit
    of the result.  Launches the CUDA kernel or raises."""
    check_block_slices(bp)
    b, p, w = xf.shape
    _check("xf", xf, (b, p, w))
    _check("rf", rf, (b, p, w))
    lib = build.library()
    out = torch.zeros((b, p), dtype=torch.float32, device=xf.device)
    vec4 = (w % 4 == 0 and xf.data_ptr() % 16 == 0
            and rf.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    err = lib.launch_patch_delta(xf.data_ptr(), rf.data_ptr(),
                                 out.data_ptr(), b * p, w, int(vec4),
                                 bp or 0, stream)
    build.check(err, "patch_delta")
    LAUNCHES.bump()
    return out
