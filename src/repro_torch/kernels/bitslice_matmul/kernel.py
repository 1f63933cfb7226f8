"""Launch wrapper of the hand-written DBSC bit-slice matmul kernel
(``csrc/bitslice_matmul.cu``; replaces the TPU kernel
``repro/kernels/bitslice_matmul/kernel.py: bitslice_matmul_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("bitslice_matmul")
DATAFLOWS = {"weight_stationary": 0, "input_stationary": 1}


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"bitslice_matmul: {name} must be a CUDA tensor")
    if x.dtype != torch.int32:
        raise ValueError(f"bitslice_matmul: {name} must be int32, "
                         f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"bitslice_matmul: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"bitslice_matmul: {name} must be contiguous")


def bitslice_matmul_kernel(x_hi: torch.Tensor, x_lo: torch.Tensor,
                           w: torch.Tensor, prec: torch.Tensor,
                           dataflow: str = "weight_stationary"
                           ) -> torch.Tensor:
    """int32 planes (M, K), weights (K, N), row flags (M, 1) on the card ->
    (M, N) int32.  Launches the CUDA kernel or raises."""
    if dataflow not in DATAFLOWS:
        raise ValueError(f"bitslice_matmul: dataflow={dataflow!r}, "
                         f"expected one of {tuple(DATAFLOWS)}")
    m, k = x_hi.shape
    n = w.shape[1]
    _check("x_hi", x_hi, (m, k))
    _check("x_lo", x_lo, (m, k))
    _check("w", w, (k, n))
    _check("prec", prec, (m, 1))
    lib = build.library()
    out = torch.empty((m, n), dtype=torch.int32, device=x_hi.device)
    stream = torch.cuda.current_stream(x_hi.device).cuda_stream
    err = lib.launch_bitslice_matmul(
        x_hi.data_ptr(), x_lo.data_ptr(), w.data_ptr(), prec.data_ptr(),
        out.data_ptr(), m, k, n, DATAFLOWS[dataflow], stream)
    build.check(err, "bitslice_matmul")
    LAUNCHES.bump()
    return out
