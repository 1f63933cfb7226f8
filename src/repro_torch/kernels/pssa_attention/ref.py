"""Plain PyTorch versions of the PSSA attention kernel (port of the JAX
``pssa_attention/ref.py``): full softmax, prune, matmul, counters."""
from __future__ import annotations

import math

import torch

from repro_torch.core import pssa


def _pruned(q, k, v, threshold):
    """(out, keep): the pruned attention and its (BH, Tq, Tk) keep bits."""
    d = q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(float(d))
    p = torch.softmax(scores, dim=-1)
    keep = p >= threshold
    out = torch.einsum("bts,bsd->btd", torch.where(keep, p, 0.0), v)
    return out, keep


def pssa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       threshold: float):
    """(BH, Tq, d) q x (BH, Tk, d) k/v -> (out, nnz): the output and
    ``nnz`` oracle, ``nnz`` the per-query int32 count of surviving
    scores."""
    out, keep = _pruned(q, k, v, threshold)
    return out, keep.sum(dim=-1, dtype=torch.int32)


def pssa_attention_stats_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, threshold: float, patch: int):
    """(BH, Tq, d) q x (BH, Tk, d) k/v -> (out, nnz, xor_ones),
    materializing the (BH, Tq, Tk) SAS; ``patch`` must divide Tk.

    ``nnz`` and ``xor_ones`` are per-query int32 counts: surviving scores,
    and ones of the patch-XOR'd keep bitmap.
    """
    out, keep = _pruned(q, k, v, threshold)
    nnz = keep.sum(dim=-1, dtype=torch.int32)
    xor_ones = pssa.patch_xor(keep, patch).sum(dim=-1, dtype=torch.int32)
    return out, nnz, xor_ones
