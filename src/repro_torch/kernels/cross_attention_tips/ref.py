"""Plain PyTorch version of the cross-attention TIPS kernel (port of the
JAX ``cross_attention_tips_ref``)."""
from __future__ import annotations

import math

import torch


def cross_attention_tips_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, cls_index: int = 0):
    """(BH, Tq, d) x (BH, Tk, d) -> (out, cas), materializing (BH, Tq, Tk)."""
    d = q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(float(d))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bts,bsd->btd", p, v)
    return out, p[..., cls_index]
