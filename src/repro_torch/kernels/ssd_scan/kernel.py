"""Launch wrapper of the hand-written SSD scan kernel (``csrc/ssd_scan.cu``;
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py:
ssd_scan_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("ssd_scan")
MAX_HEAD_DIM = 64       # p: rows of the on-chip state
MAX_STATE = 128         # n: columns of the on-chip state


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"ssd_scan: {name} must be a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"ssd_scan: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"ssd_scan: {name} must be contiguous")


def ssd_scan_kernel(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: int = 128, heads: int = 1):
    """Fused SSD over folded heads, on the card.

    x (BH, T, p) float32, pre-multiplied by dt; dA (BH, T) float32;
    B, C (BH / heads, T, n) float32: row ``bh`` reads B and C row
    ``bh // heads``, so the model's per-batch B and C need no copy per
    head (``heads=1`` is the TPU kernel's folded contract).
    Returns (y (BH, T, p), final_state (BH, p, n)), float32.
    Launches the CUDA kernel or raises.
    """
    bh, t, p = x.shape
    n = B.shape[-1]
    if heads < 1 or bh % heads:
        raise ValueError(f"ssd_scan: heads={heads} must divide BH={bh}")
    _check("x", x, (bh, t, p))
    _check("dA", dA, (bh, t))
    _check("B", B, (bh // heads, t, n))
    _check("C", C, (bh // heads, t, n))
    if not 1 <= p <= MAX_HEAD_DIM or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: p={p} and n={n} must lie in "
                         f"[1, {MAX_HEAD_DIM}] and [1, {MAX_STATE}]")
    if chunk < 1 or t % chunk:
        raise ValueError(f"ssd_scan: chunk={chunk} must divide T={t}")
    lib = build.library()
    y = torch.empty((bh, t, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bh, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.launch_ssd_scan(x.data_ptr(), dA.data_ptr(), B.data_ptr(),
                              C.data_ptr(), y.data_ptr(), state.data_ptr(),
                              bh, t, p, n, chunk, heads, stream)
    build.check(err, "ssd_scan")
    LAUNCHES.bump()
    return y, state
