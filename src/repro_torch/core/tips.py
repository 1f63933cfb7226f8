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
