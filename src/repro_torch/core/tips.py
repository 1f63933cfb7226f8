"""TIPS — text-based important pixel spotting (port of ``repro.core.tips``).

A small CLS attention score (CAS) marks a pixel tied to the prompt; those
rows keep INT12 through the FFN, the rest drop to INT6.  TIPS is active for
the first 20 of 25 denoising iterations.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import quant

TIPS_ACTIVE_ITERS = 20
TOTAL_ITERS = 25


class TIPSResult(NamedTuple):
    important: torch.Tensor           # bool (..., Tq): True -> keep INT12
    cas: torch.Tensor                 # (..., Tq) CLS attention score
    low_precision_ratio: torch.Tensor  # float32 scalar in [0, 1]


class TIPSRowCounters(NamedTuple):
    """Per-batch-row TIPS accounting (slot serving): ``important`` (B,)
    int64 counts each row's spotted-important tokens (before the
    tips-active OR: the ledger applies the activity schedule per
    iteration)."""
    important: torch.Tensor


def spot(cross_attn_probs: torch.Tensor, threshold: float,
         cls_index: int = 0) -> TIPSResult:
    """Spot important pixels from post-softmax cross-attention scores
    (..., heads, Tq, Tk_text): the CLS score averaged over heads, and
    important <=> CAS < threshold."""
    cas = cross_attn_probs[..., :, cls_index].mean(dim=-2)     # (..., Tq)
    important = cas < threshold
    return TIPSResult(important=important, cas=cas,
                      low_precision_ratio=mask_low_precision_ratio(important))


def low_precision_ratio(count: torch.Tensor, n: int) -> torch.Tensor:
    """``1 - count / n`` (float32) as the JAX engine computes ``1 -
    mean(important)`` under ``jit``: XLA turns the mean's division by the
    constant n into a product by ``float32(1 / n)`` and fuses the
    subtraction into one FMA, so the exact ``1 - count * float32(1 / n)``
    is rounded once (eager JAX rounds the product first; dividing rounds
    otherwise again: each can land an ulp of the mean away when n is not
    a power of two).

    ``count`` is an integer tensor (any shape: one ratio an element), n
    the tokens counted.  With ``float32(1 / n) = m * 2**-k`` (m a 24-bit
    integer) the value is ``(2**k - count * m) * 2**-k``: the integer is
    exact in int64, its conversion to float32 the one rounding, the power
    of two exact.  NaN at n = 0, as the mean of nothing.
    """
    count = count.to(torch.int64)
    if n == 0:
        return torch.full(count.shape, float("nan"), dtype=torch.float32,
                          device=count.device)
    mant, e = math.frexp(float(torch.tensor(1.0, dtype=torch.float32) / n))
    m, k = int(mant * (1 << 24)), 24 - e
    return ((1 << k) - count * m).to(torch.float32) * 2.0 ** -k


def mask_low_precision_ratio(important: torch.Tensor) -> torch.Tensor:
    """:func:`low_precision_ratio` of a mask: its count over its size."""
    return low_precision_ratio(important.sum(dtype=torch.int64),
                               important.numel())


def adaptive_threshold(cas: torch.Tensor, target_low_ratio: float,
                       dim=None) -> torch.Tensor:
    """Threshold that marks ``1 - target_low_ratio`` of the tokens
    important: the linear quantile of the CAS over all of it (``dim``
    None, a scalar) or along ``dim`` (kept as size 1), computed as the JAX
    package's ``jnp.quantile`` is (``torch.quantile`` interpolates with
    another rounding): float32 position and weights, then ``hi * w_high +
    lo * w_low`` with the first product fused into the add, as XLA's CPU
    backend contracts it (the exact product plus the rounded second one,
    added in float64 and rounded once more).  NaN where a reduced CAS is
    NaN."""
    f32 = torch.float32
    a, d = (cas.reshape(-1), 0) if dim is None else (cas, dim)
    a = torch.sort(torch.where(torch.isnan(a).any(dim=d, keepdim=True),
                               torch.full_like(a, float("nan")), a),
                   dim=d).values
    n = a.shape[d]
    q = torch.tensor(1.0 - target_low_ratio, dtype=f32,
                     device=a.device) * float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    lo = a.index_select(d, low.clamp(0, n - 1).to(torch.int64).reshape(1))
    hi = a.index_select(d, high.clamp(0, n - 1).to(torch.int64).reshape(1))
    fused = (hi.to(torch.float64) * w_high.to(torch.float64)
             + (lo.to(f32) * w_low).to(torch.float64))
    out = fused.to(f32).to(cas.dtype)
    return out.reshape(()) if dim is None else out


def tips_schedule(iteration, active_iters: int = TIPS_ACTIVE_ITERS
                  ) -> torch.Tensor:
    """True while TIPS may down-quantize (the first 20 of 25
    iterations)."""
    return torch.as_tensor(iteration) < active_iters


def apply_precision_mask(x: torch.Tensor, important: torch.Tensor,
                         active=True) -> torch.Tensor:
    """Fake-quant an activation tensor per the TIPS mask.

    Important rows round-trip INT12, the others INT6 on the same grid; with
    ``active`` False every row stays INT12.  The scale is PER SAMPLE
    (reduced over every non-batch axis), so a fused cond+uncond batch gives
    the same rows as two separate calls.
    """
    if isinstance(active, bool):
        # no host-to-device copy (it would hold the host until the card
        # caught up, once per FFN)
        imp = important if active else torch.ones_like(important)
    else:
        active = torch.as_tensor(active, device=x.device)
        imp = torch.logical_or(important, torch.logical_not(active))
    axes = tuple(range(1, x.ndim))
    amax = torch.clamp_min(x, 0.0).amax(dim=axes, keepdim=True)
    # the jitted JAX scale (see core.quant): amax / 4095 in x's dtype (a
    # Python int takes the array's dtype: 4096 in bfloat16), taken as a
    # float32 product by the inverse and rounded to x's dtype
    div = torch.tensor(quant.ACT_HIGH_MAX, dtype=x.dtype).item()
    scale = (torch.clamp_min(amax, 1e-8).to(torch.float32)
             * (1.0 / div)).to(x.dtype)
    q = quant.mixed_precision_quantize(x, imp, scale=scale)
    y = (q.values.to(torch.float32) * q.scale).to(x.dtype)
    # straight-through: the forward value is the JAX form x + (y - x),
    # kept for its rounding; the gradient is the identity, as under JAX's
    # stop_gradient
    return x + (y - x).detach()


def workload_low_precision_fraction(ratios_per_iter,
                                    active_iters: int | None = None,
                                    total_iters: int | None = None,
                                    *, ddim=None) -> torch.Tensor:
    """Fraction of the run's FFN workload eligible for INT6 (paper Fig.
    9(b): the per-iteration ratio, zero after the TIPS-active window).

    The schedule is the run's: pass its ``DDIMConfig`` as ``ddim`` (or
    the two counts); the paper's 20 of 25 iterations is the fallback when
    neither is given.  The active ratios are added in order in float32,
    as the JAX package's eager sum does for up to 32 of them (a
    vectorized sum would round otherwise).
    """
    if ddim is not None:
        if active_iters is None:
            active_iters = ddim.tips_active_iters
        if total_iters is None:
            total_iters = ddim.num_inference_steps
    if active_iters is None:
        active_iters = TIPS_ACTIVE_ITERS
    if total_iters is None:
        total_iters = TOTAL_ITERS
    total = torch.zeros((), dtype=torch.float32)
    for r in torch.as_tensor(ratios_per_iter,
                             dtype=torch.float32)[:active_iters]:
        total = total + r
    return total / total_iters
