"""Plain PyTorch version of the patch-delta kernel (port of the JAX
``patch_delta_ref``): per-patch max-abs change for temporal reuse."""
from __future__ import annotations

import torch


def patch_delta_ref(x: torch.Tensor, x_ref: torch.Tensor,
                    patch: int) -> torch.Tensor:
    """(B, T, C) tokens vs cached reference -> (B, T/patch) float32.

    Tokens are grouped in contiguous runs of ``patch``; a patch's delta is
    the max |x - x_ref| over its tokens and channels (NaN propagates).
    """
    b, t, c = x.shape
    if t % patch:
        raise ValueError(f"patch_delta: T={t} is not a multiple of patch "
                         f"{patch}")
    d = (x.to(torch.float32) - x_ref.to(torch.float32)).abs()
    return d.reshape(b, t // patch, patch * c).amax(dim=-1)
