"""Launch wrapper of the hand-written patch-delta kernel
(``csrc/patch_delta.cu``; replaces the TPU kernel
``repro/kernels/patch_reuse/kernel.py: patch_delta_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("patch_delta")


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


def patch_delta_kernel(xf: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """(B, P, patch*C) folded tokens and reference on the card -> (B, P)
    float32 max-abs delta.  Launches the CUDA kernel or raises."""
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
                                 stream)
    build.check(err, "patch_delta")
    LAUNCHES.bump()
    return out
