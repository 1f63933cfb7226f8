"""TIPS — text-based important pixel spotting (port of ``repro.core.tips``).

A small CLS attention score (CAS) marks a pixel tied to the prompt; those
rows keep INT12 through the FFN, the rest drop to INT6.  TIPS is active for
the first 20 of 25 denoising iterations.
"""
from __future__ import annotations

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


def apply_precision_mask(x: torch.Tensor, important: torch.Tensor,
                         active=True) -> torch.Tensor:
    """Fake-quant an activation tensor per the TIPS mask.

    Important rows round-trip INT12, the others INT6 on the same grid; with
    ``active`` False every row stays INT12.  The scale is PER SAMPLE
    (reduced over every non-batch axis), so a fused cond+uncond batch gives
    the same rows as two separate calls.
    """
    active = torch.as_tensor(active, device=x.device)
    imp = torch.logical_or(important, torch.logical_not(active))
    axes = tuple(range(1, x.ndim))
    amax = torch.clamp_min(x, 0.0).amax(dim=axes, keepdim=True)
    # the jitted JAX scale (see core.quant): amax * float32(1 / 4095)
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / quant.ACT_HIGH_MAX)
    q = quant.mixed_precision_quantize(x, imp, scale=scale)
    y = (q.values.to(torch.float32) * q.scale).to(x.dtype)
    # the JAX straight-through form x + (y - x), kept for its rounding
    return x + (y - x)


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
