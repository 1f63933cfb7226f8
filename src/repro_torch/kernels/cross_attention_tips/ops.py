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

from repro_torch.kernels import runtime
from repro_torch.kernels.cross_attention_tips.kernel import (
    block_q_choices, check_block_q, cross_attention_heads_kernel)
from repro_torch.kernels.cross_attention_tips.ref import (
    cross_attention_tips_ref)


def cross_attention_cas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cls_index: int = 0, bq: int | None = None):
    """(B, H, Tq, d) q x (B, H, Tk, d) text k/v -> (out (B, H, Tq, d),
    cas (B, H, Tq)), ``cas`` the per-head softmax mass on key
    ``cls_index``.  ``bq`` is the kernel's query rows a block
    (``kernel.check_block_q``; ``None``: its launch rule); it moves no bit,
    and the plain version has none."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    check_block_q(bq, d)
    if q.is_cuda:
        # the kernel needs only d contiguous, which the head split keeps
        return cross_attention_heads_kernel(
            *(x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v)),
            cls_index, bq=bq)
    out, cas = cross_attention_tips_ref(q.reshape(b * h, tq, d),
                                        k.reshape(b * h, tk, d),
                                        v.reshape(b * h, tk, d), cls_index)
    return out.reshape(b, h, tq, d), cas.reshape(b, h, tq)


# ---------------------------------------------------------------------------
# Autotune hooks (repro_torch.kernels.autotune): geometry = (b, h, tq, d, tk)
# ---------------------------------------------------------------------------
AUTOTUNE_KNOBS = ("cross_block_q",)


def autotune_candidates(geom: tuple) -> tuple:
    """Every query-rows-a-block the kernel takes at this d (16, 32, 64,
    128; 16 alone from d = 81 on, where 4 warps split d), so the launch
    rule's own choice (the most warps that still give every SM a block)
    is always among them."""
    b, h, tq, d, tk = geom
    return tuple({"cross_block_q": s} for s in block_q_choices(d))


def autotune_probe(geom: tuple, blocks: dict, *, device=None):
    """(fn, input sets) the autotuner times for one block config."""
    b, h, tq, d, tk = geom
    dev = runtime.resolve_device(device)
    n = runtime.rotation(4 * b * h * (tq + 2 * tk) * d, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((n, b, h, tq, d), device=dev, generator=gen)
    kv = torch.randn((n, 2, b, h, tk, d), device=dev, generator=gen)

    def fn(q, k, v):
        return cross_attention_cas(q, k, v, bq=blocks["cross_block_q"])
    return fn, [(q[i], kv[i, 0], kv[i, 1]) for i in range(n)]
