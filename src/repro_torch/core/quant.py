"""Quantization primitives (port of ``repro.core.quant``).

The paper's datapath is A:INT12 (unsigned) / W:INT8 (signed), with TIPS
dropping selected activations to INT6.  The DBSC splits the 12-bit unsigned
activation into two 6-bit slices: ``x = hi * 2**6 + lo``, both in [0, 63].
Integer payloads are held in int32 (exact at these widths).

``torch.round`` rounds half to even, like ``jnp.round``, so the integer
codes match the JAX package exactly.  Scales are ``amax * (1 / qmax)``
with the reciprocal rounded to float32: that is what XLA compiles the JAX
package's ``amax / qmax`` to inside ``jit`` (it rewrites a division by a
constant), and every JAX call on the model's path is jitted, so this is
the scale the reference actually uses.  A plain division differs from it
by one ulp on about 70 % of inputs, which moves the DBSC float output.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ACT_BITS_HIGH = 12   # INT12 unsigned activations
ACT_BITS_LOW = 6     # INT6 unsigned activations (TIPS unimportant tokens)
WEIGHT_BITS = 8      # INT8 signed weights
SLICE_BITS = 7       # DBSC bit-slice PEs multiply int7 x int8

ACT_HIGH_MAX = (1 << ACT_BITS_HIGH) - 1   # 4095
ACT_LOW_MAX = (1 << ACT_BITS_LOW) - 1     # 63
WEIGHT_MAX = (1 << (WEIGHT_BITS - 1)) - 1  # 127
SLICE_MASK = (1 << 6) - 1                  # low 6 bits of a slice


class QTensor(NamedTuple):
    """Integer values plus the float scale used to (de)quantize."""
    values: torch.Tensor   # int32, exact integer payload
    scale: torch.Tensor    # float32 scalar or per-channel


def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        return x.max()
    return x.amax(dim=axis, keepdim=True)


def quantize_act(x: torch.Tensor, bits: int = ACT_BITS_HIGH,
                 axis=None, amax: torch.Tensor | None = None) -> QTensor:
    """Unsigned activation quantization; the scale spans ``max(x, 0)``,
    or ``amax`` when given (a data-parallel group's max of it)."""
    qmax = (1 << bits) - 1
    if amax is None:
        amax = _amax(torch.clamp_min(x, 0.0), axis)
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / qmax)
    q = torch.clamp(torch.round(x / scale), 0, qmax).to(torch.int32)
    return QTensor(q, scale.to(torch.float32))


def quantize_weight(w: torch.Tensor, bits: int = WEIGHT_BITS,
                    axis=None) -> QTensor:
    """Symmetric signed weight quantization (per-tensor or per-channel)."""
    qmax = (1 << (bits - 1)) - 1
    amax = _amax(w.abs(), axis)
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / qmax)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int32)
    return QTensor(q, scale.to(torch.float32))


def dequantize(q: QTensor) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scale


def fake_quant_act(x: torch.Tensor, bits: int = ACT_BITS_HIGH,
                   axis=None) -> torch.Tensor:
    """Round-trip quantization (straight-through: the gradient is the
    identity, as under JAX's ``stop_gradient``)."""
    y = dequantize(quantize_act(x, bits, axis))
    return x + (y - x).detach()


def fake_quant_weight(w: torch.Tensor, bits: int = WEIGHT_BITS,
                      axis=None) -> torch.Tensor:
    y = dequantize(quantize_weight(w, bits, axis))
    return w + (y - w).detach()


def bitslice_split(x_int: torch.Tensor):
    """Split an unsigned INT12 payload into (hi, lo) 6-bit planes."""
    lo = torch.bitwise_and(x_int, SLICE_MASK)
    hi = torch.bitwise_right_shift(x_int, 6)
    return hi.to(torch.int32), lo.to(torch.int32)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    x = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer (M, K) @ (K, N) -> exact int64: int64 on the CPU, float64 on
    the card (``torch.matmul`` has no integer kernel there; exact while
    every partial sum stays below 2**53)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int64)
    return a @ b


def bitslice_merge(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitslice_split`: ``(hi << 6) + lo``."""
    return torch.bitwise_left_shift(hi, 6) + lo


def quantized_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                               precision_bits: int = ACT_BITS_HIGH
                               ) -> torch.Tensor:
    """INT-exact ``x @ w`` on per-tensor scales: the integer oracle of the
    DBSC datapath, float32 out.

    The integer product is exact and wraps to int32 as XLA's does
    (:func:`exact_matmul`, which the plain bit-slice kernel shares, not
    its bit-slice decomposition, which this checks).  The rescale is the
    jitted JAX package's: XLA reassociates ``acc * (sx * sw)`` with ``sx = ax *
    (1/qx)`` and ``sw = aw * (1/qw)`` into ``acc * ((ax * aw) * c)``, the
    constant ``c = (1/qx) * (1/qw)`` folded in float32.
    """
    qx = quantize_act(x, precision_bits)
    qw = quantize_weight(w)
    acc = wrap_int32(exact_matmul(qx.values, qw.values))
    ax = torch.clamp_min(torch.clamp_min(x, 0.0).max(), 1e-8)
    aw = torch.clamp_min(w.abs().max(), 1e-8)
    f32 = torch.float32
    c = (torch.tensor(1.0 / ((1 << precision_bits) - 1), dtype=f32)
         * torch.tensor(1.0 / WEIGHT_MAX, dtype=f32)).item()
    return acc.to(f32) * ((ax.to(f32) * aw.to(f32)) * c)


def mixed_precision_quantize(x: torch.Tensor, important: torch.Tensor,
                             scale: torch.Tensor | None = None) -> QTensor:
    """TIPS mixed precision: important rows INT12, the rest INT6 on the
    same scale grid (the low 6 bits of the INT12 code dropped).  ``x /
    scale`` is rounded to their common dtype before it is rounded to an
    integer, as in the JAX package (bfloat16 for a bfloat16 pair)."""
    if scale is None:
        q = quantize_act(x, ACT_BITS_HIGH)
    else:
        scale = torch.as_tensor(scale, device=x.device)
        q = QTensor(torch.clamp(torch.round(x / scale), 0, ACT_HIGH_MAX)
                    .to(torch.int32), scale.to(torch.float32))
    low = torch.bitwise_left_shift(torch.bitwise_right_shift(q.values, 6), 6)
    vals = torch.where(important[..., None], q.values, low)
    return QTensor(vals, q.scale)
