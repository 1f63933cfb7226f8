"""Plain PyTorch version of the PSXU patch-bitmap kernel (port of the JAX
``patch_bitmap_ref``)."""
from __future__ import annotations

import torch

from repro_torch.core import pssa


def patch_bitmap_ref(sas: torch.Tensor, patch: int, threshold: float):
    """(R, Tk) SAS -> (packed (R, Tk/32) uint32, counts (R, Tk/patch)
    int32): the patch-XOR'd keep bitmap, 32 keys per word with key
    32w + i at bit i, and its popcount per patch."""
    rows, tk = sas.shape
    if tk % patch or tk % 32:
        raise ValueError(f"patch_bitmap: Tk={tk} must be a multiple of 32 "
                         f"and of patch {patch}")
    delta = pssa.patch_xor(sas >= threshold, patch)
    counts = delta.reshape(rows, tk // patch, patch).sum(
        dim=-1, dtype=torch.int32)
    lanes = torch.arange(32, dtype=torch.int64, device=sas.device)
    words = (delta.reshape(rows, tk // 32, 32).to(torch.int64)
             << lanes).sum(dim=-1)
    # [0, 2**32) as the int32 of the same bits, then viewed as uint32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).view(torch.uint32), counts
