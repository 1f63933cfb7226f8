"""Launch wrapper of the hand-written DBSC bit-slice matmul kernel
(``csrc/bitslice_matmul.cu``; replaces the TPU kernel
``repro/kernels/bitslice_matmul/kernel.py: bitslice_matmul_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("bitslice_matmul")
DATAFLOWS = {"weight_stationary": 0, "input_stationary": 1}
# The kernel accumulates each plane's products in s32 on the tensor cores:
# |plane * w| <= 63 * 128, so K up to this keeps both sums below 2**31.
K_MAX = (2 ** 31 - 1) // (63 * 128)


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
    (M, N) int32.  Launches the CUDA kernel or raises.

    Domain: ``x_hi`` and ``x_lo`` in [0, 63] (``quant.bitslice_split`` of
    an unsigned INT12 code), ``w`` in [-128, 127] (``quant.quantize_weight``)
    and ``prec`` in {0, 1}: the TPU kernel's contract and what ``ops.py``
    feeds.  The kernel narrows every operand to int8 for the tensor cores,
    so within the domain it equals ``bitslice_matmul_ref`` bit for bit;
    outside it the result is not defined.  K above ``K_MAX`` raises.
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"bitslice_matmul: dataflow={dataflow!r}, "
                         f"expected one of {tuple(DATAFLOWS)}")
    m, k = x_hi.shape
    n = w.shape[1]
    _check("x_hi", x_hi, (m, k))
    _check("x_lo", x_lo, (m, k))
    _check("w", w, (k, n))
    _check("prec", prec, (m, 1))
    if k > K_MAX:
        raise ValueError(f"bitslice_matmul: K={k} exceeds {K_MAX}, past "
                         f"which an s32 accumulator can overflow")
    lib = build.library()
    out = torch.empty((m, n), dtype=torch.int32, device=x_hi.device)
    stream = torch.cuda.current_stream(x_hi.device).cuda_stream
    err = lib.launch_bitslice_matmul(
        x_hi.data_ptr(), x_lo.data_ptr(), w.data_ptr(), prec.data_ptr(),
        out.data_ptr(), m, k, n, DATAFLOWS[dataflow], stream)
    build.check(err, "bitslice_matmul")
    LAUNCHES.bump()
    return out
