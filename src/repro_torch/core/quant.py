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
                 axis=None) -> QTensor:
    """Unsigned activation quantization; the scale spans ``max(x, 0)``."""
    qmax = (1 << bits) - 1
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


def bitslice_split(x_int: torch.Tensor):
    """Split an unsigned INT12 payload into (hi, lo) 6-bit planes."""
    lo = torch.bitwise_and(x_int, SLICE_MASK)
    hi = torch.bitwise_right_shift(x_int, 6)
    return hi.to(torch.int32), lo.to(torch.int32)


def mixed_precision_quantize(x: torch.Tensor, important: torch.Tensor,
                             scale: torch.Tensor | None = None) -> QTensor:
    """TIPS mixed precision: important rows INT12, the rest INT6 on the
    same scale grid (the low 6 bits of the INT12 code dropped)."""
    if scale is None:
        q = quantize_act(x, ACT_BITS_HIGH)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        q = QTensor(torch.clamp(torch.round(x / scale), 0, ACT_HIGH_MAX)
                    .to(torch.int32), scale)
    low = torch.bitwise_left_shift(torch.bitwise_right_shift(q.values, 6), 6)
    vals = torch.where(important[..., None], q.values, low)
    return QTensor(vals, q.scale)
