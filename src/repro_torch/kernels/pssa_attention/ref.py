"""Plain PyTorch version of the PSSA attention kernel (port of the JAX
``pssa_attention_stats_ref``): full softmax, prune, matmul, counters."""
from __future__ import annotations

import math

import torch

from repro_torch.core import pssa


def pssa_attention_stats_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, threshold: float, patch: int):
    """(BH, Tq, d) q x (BH, Tk, d) k/v -> (out, nnz, xor_ones),
    materializing the (BH, Tq, Tk) SAS; ``patch`` must divide Tk.

    ``nnz`` and ``xor_ones`` are per-query int32 counts: surviving scores,
    and ones of the patch-XOR'd keep bitmap.
    """
    d = q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(float(d))
    p = torch.softmax(scores, dim=-1)
    keep = p >= threshold
    out = torch.einsum("bts,bsd->btd", torch.where(keep, p, 0.0), v)
    nnz = keep.sum(dim=-1, dtype=torch.int32)
    xor_ones = pssa.patch_xor(keep, patch).sum(dim=-1, dtype=torch.int32)
    return out, nnz, xor_ones
