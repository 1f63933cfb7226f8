"""Plain PyTorch version of the DBSC bit-slice matmul (port of the JAX
``bitslice_matmul_ref``), bit-identical to the kernel and to XLA's int32,
and the ``int8`` datapath (port of ``bitslice_matmul_int8``).

``torch.matmul`` has no int32 kernel on CUDA, so on the card the two
products run in float64 — exact, since every partial sum stays below
2**53 (|acc| <= 63 * 128 * K) — and are converted back to int64.  On the
CPU they run in int64.  The shift and add then happen in int64 and the
result is wrapped to int32, which is what XLA's int32 arithmetic does
silently when ``acc_hi << 6`` passes 2**31.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import exact_matmul, wrap_int32


def bitslice_matmul_ref(x_hi: torch.Tensor, x_lo: torch.Tensor,
                        w: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """int32 planes (M, K), weights (K, N), row flags (M, 1) -> (M, N) int32.

    ``prec`` 1 -> INT12 row (both slices), 0 -> INT6 row (high slice only).
    """
    lo = x_lo.to(torch.int64) * prec.to(torch.int64)
    acc_hi = exact_matmul(x_hi, w)
    acc_lo = exact_matmul(lo, w)
    return wrap_int32(torch.bitwise_left_shift(acc_hi, 6) + acc_lo)


def bitslice_matmul_int8(x_hi: torch.Tensor, x_lo: torch.Tensor,
                         w: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """The same integers through int8 x int8 -> int32 products.

    The operands fit int8 exactly: each activation slice lies in [0, 63]
    (``quant.bitslice_split``) and the weights in [-128, 127], and ``prec``
    gates the low slice before the narrowing, as the JAX package's
    ``bitslice_matmul_int8`` does.  The two products are
    ``torch._int_mm`` calls, the counterpart of XLA's int8
    ``dot_general`` (a plain library product outside any kernel, as the
    JAX package leaves it to XLA), and the shift-add runs in int32, which
    wraps as XLA's does.  Where ``_int_mm`` refuses a shape (on the card:
    M <= 16, or K or N not a multiple of 8) it raises; nothing falls back.
    """
    hi8 = x_hi.to(torch.int8)
    lo8 = (x_lo * prec).to(torch.int8)
    w8 = w.to(torch.int8)
    acc_hi = torch._int_mm(hi8, w8)
    acc_lo = torch._int_mm(lo8, w8)
    return torch.bitwise_left_shift(acc_hi, 6) + acc_lo
