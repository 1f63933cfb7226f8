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
    if not x.is_contiguous():
        raise ValueError(f"cross_attention_tips: {name} must be contiguous")


def cross_attention_tips_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, cls_index: int = 0):
    """(BH, Tq, d) q x (BH, Tk, d) text k/v on the card -> (out, cas).

    Launches the CUDA kernel or raises; there is no other route.
    """
    bh, tq, d = q.shape
    tk = k.shape[1]
    _check("q", q, (bh, tq, d))
    _check("k", k, (bh, tk, d))
    _check("v", v, (bh, tk, d))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"cross_attention_tips: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if not 1 <= tk <= MAX_TEXT_KEYS:
        raise ValueError(f"cross_attention_tips: {tk} text keys outside "
                         f"[1, {MAX_TEXT_KEYS}]")
    if not 0 <= cls_index < tk:
        raise ValueError(f"cross_attention_tips: cls_index {cls_index} "
                         f"outside the {tk} text keys")
    lib = build.library()
    out = torch.empty_like(q)
    cas = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.launch_cross_attention_tips(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cas.data_ptr(), bh, tq, tk, d, cls_index, float(d) ** 0.5, stream)
    build.check(err, "cross_attention_tips")
    LAUNCHES.bump()
    return out, cas
