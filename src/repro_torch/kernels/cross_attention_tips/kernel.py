"""Launch wrapper of the hand-written cross-attention TIPS kernel
(``csrc/cross_attention_tips.cu``; replaces the TPU kernel
``repro/kernels/cross_attention_tips/kernel.py:
cross_attention_tips_kernel``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("cross_attention_tips")
MAX_TEXT_KEYS = 128
MAX_HEAD_DIM = 160
MAX_BATCH_HEADS = 65535         # the grid's second dimension
SPLIT_D_FROM = 81               # from this d on, 4 warps share a 16-row tile


def block_q_choices(d: int) -> tuple:
    """Query rows a block the kernel takes at head dim ``d``: 16 a warp,
    1-8 warps; one 16-row tile where 4 warps split d."""
    return (16,) if d >= SPLIT_D_FROM else (16, 32, 64, 128)


def check_block_q(bq, d: int) -> None:
    """Raise unless ``bq`` is ``None`` (the launch rule) or a value of
    ``block_q_choices(d)``; a value is never clamped."""
    if bq is not None and bq not in block_q_choices(d):
        raise ValueError(f"cross_attention_tips: block_q={bq!r} at d={d}, "
                         f"expected None or one of {block_q_choices(d)}")


def _check(name, x, shape):
    if not x.is_cuda:
        raise ValueError(f"cross_attention_tips: {name} must be a CUDA "
                         f"tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"cross_attention_tips: {name} must be float32, "
                         f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"cross_attention_tips: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"cross_attention_tips: {name} must have its last "
                         f"dimension contiguous")


def cross_attention_heads_kernel(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cls_index: int = 0,
                                 bq: int | None = None):
    """(B, H, Tq, d) q x (B, H, Tk, d) text k/v on the card -> (out, cas).

    Any (batch, head, row) strides with d contiguous: the kernel reads
    through them, so the UNet's head-split views go in uncopied.  ``out``
    is written as (B, Tq, H, d) memory and returned as its (B, H, Tq, d)
    view, so merging the heads back is a reshape without a copy; ``cas``
    is (B, H, Tq).  ``bq`` query rows a block (``check_block_q``;
    ``None``: the launch rule) moves no bit of the result.  Launches the
    CUDA kernel or raises; there is no other route.
    """
    b, h, tq, d = q.shape
    check_block_q(bq, d)
    tk = k.shape[2]
    _check("q", q, (b, h, tq, d))
    _check("k", k, (b, h, tk, d))
    _check("v", v, (b, h, tk, d))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"cross_attention_tips: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if not 1 <= tk <= MAX_TEXT_KEYS:
        raise ValueError(f"cross_attention_tips: {tk} text keys outside "
                         f"[1, {MAX_TEXT_KEYS}]")
    if not 0 <= cls_index < tk:
        raise ValueError(f"cross_attention_tips: cls_index {cls_index} "
                         f"outside the {tk} text keys")
    if not 1 <= b * h <= MAX_BATCH_HEADS:
        raise ValueError(f"cross_attention_tips: {b} x {h} batch heads "
                         f"outside [1, {MAX_BATCH_HEADS}]")
    lib = build.library()
    out = torch.empty((b, tq, h, d), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    cas = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    err = lib.launch_cross_attention_tips(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cas.data_ptr(), b, h, tq, tk, d, cls_index, float(d) ** 0.5,
        *strides, bq or 0, stream)
    build.check(err, "cross_attention_tips")
    LAUNCHES.bump()
    return out, cas


def cross_attention_tips_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, cls_index: int = 0,
                                bq: int | None = None):
    """(BH, Tq, d) q x (BH, Tk, d) text k/v on the card, d contiguous ->
    (out (BH, Tq, d), cas (BH, Tq)): the kernel with one head a batch row.

    Launches the CUDA kernel or raises; there is no other route.
    """
    bh, tq, d = q.shape
    out, cas = cross_attention_heads_kernel(
        q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), cls_index, bq)
    return out.reshape(bh, tq, d), cas.reshape(bh, tq)
