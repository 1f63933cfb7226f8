"""Plain PyTorch version of the DBSC bit-slice matmul (port of the JAX
``bitslice_matmul_ref``), bit-identical to the kernel and to XLA's int32.

``torch.matmul`` has no int32 kernel on CUDA, so on the card the two
products run in float64 — exact, since every partial sum stays below
2**53 (|acc| <= 63 * 128 * K) — and are converted back to int64.  On the
CPU they run in int64.  The shift and add then happen in int64 and the
result is wrapped to int32, which is what XLA's int32 arithmetic does
silently when ``acc_hi << 6`` passes 2**31.
"""
from __future__ import annotations

import torch


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    x = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def bitslice_matmul_ref(x_hi: torch.Tensor, x_lo: torch.Tensor,
                        w: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """int32 planes (M, K), weights (K, N), row flags (M, 1) -> (M, N) int32.

    ``prec`` 1 -> INT12 row (both slices), 0 -> INT6 row (high slice only).
    """
    lo = x_lo.to(torch.int64) * prec.to(torch.int64)
    hi = x_hi.to(torch.int64)
    wl = w.to(torch.int64)
    if x_hi.is_cuda:
        acc_hi = (hi.double() @ wl.double()).to(torch.int64)
        acc_lo = (lo.double() @ wl.double()).to(torch.int64)
    else:
        acc_hi = hi @ wl
        acc_lo = lo @ wl
    return wrap_int32(torch.bitwise_left_shift(acc_hi, 6) + acc_lo)
