"""Public op: cross-attention with the CAS side output over (B, H, Tq, d).

A CUDA tensor goes through the hand-written kernel, which holds the whole
text stripe and masks keys past Tk itself (the JAX package pads them to a
multiple of 8 for the TPU's sublanes; the CUDA kernel pads and masks in
shared memory).  It reads q, k and v through their strides and writes
``out`` as (B, Tq, H, d) memory seen as (B, H, Tq, d), so neither the
UNet's head split nor its head merge copies.  A CPU tensor goes through
the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cross_attention_tips.kernel import (
    cross_attention_heads_kernel)
from repro_torch.kernels.cross_attention_tips.ref import (
    cross_attention_tips_ref)


def cross_attention_cas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cls_index: int = 0):
    """(B, H, Tq, d) q x (B, H, Tk, d) text k/v -> (out (B, H, Tq, d),
    cas (B, H, Tq)), ``cas`` the per-head softmax mass on key
    ``cls_index``."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if q.is_cuda:
        # the kernel needs only d contiguous, which the head split keeps
        return cross_attention_heads_kernel(
            *(x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v)),
            cls_index)
    out, cas = cross_attention_tips_ref(q.reshape(b * h, tq, d),
                                        k.reshape(b * h, tk, d),
                                        v.reshape(b * h, tk, d), cls_index)
    return out.reshape(b, h, tq, d), cas.reshape(b, h, tq)
