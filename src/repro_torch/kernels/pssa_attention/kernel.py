"""Launch wrapper of the hand-written PSSA attention kernel
(``csrc/pssa_attention.cu``; replaces the TPU kernel
``repro/kernels/pssa_attention/kernel.py: pssa_attention_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import launch_counter

LAUNCHES = launch_counter("pssa_attention")
BLOCK_K = 64          # key tile of the CUDA kernel; patches must divide it
MAX_HEAD_DIM = 160
# the launch knob the kernel takes (``None``: its launch rule): query rows
# a block, 16 a warp
BLOCK_Q_CHOICES = (16, 32, 64)


def check_block_q(bq) -> None:
    """Raise unless ``bq`` is ``None`` or a launch knob the kernel takes;
    a value is never clamped."""
    if bq is not None and bq not in BLOCK_Q_CHOICES:
        raise ValueError(f"pssa_attention: block_q={bq!r}, expected None or "
                         f"one of {BLOCK_Q_CHOICES}")


def _check(name, x, dtype, shape):
    if not x.is_cuda:
        raise ValueError(f"pssa_attention: {name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"pssa_attention: {name} must be {dtype}, "
                         f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"pssa_attention: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"pssa_attention: {name} must be contiguous")


def pssa_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          threshold: float, patch: int, bq: int | None = None):
    """(BH, Tq, d) q x (BH, Tk, d) k/v on the card -> (out, nnz, xor_ones).

    ``bq``, the query rows a block (``check_block_q``; ``None``: the launch
    rule), moves no bit of the result.  Launches the CUDA kernel or raises;
    there is no other route.
    """
    check_block_q(bq)
    bh, tq, d = q.shape
    tk = k.shape[1]
    _check("q", q, torch.float32, (bh, tq, d))
    _check("k", k, torch.float32, (bh, tk, d))
    _check("v", v, torch.float32, (bh, tk, d))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"pssa_attention: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if BLOCK_K % patch or tk % patch:
        raise ValueError(f"pssa_attention: patch {patch} must divide the "
                         f"key tile {BLOCK_K} and the key length {tk}")
    lib = build.library()
    out = torch.empty_like(q)
    nnz = torch.empty((bh, tq), dtype=torch.int32, device=q.device)
    xor_ones = torch.empty((bh, tq), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.launch_pssa_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        nnz.data_ptr(), xor_ones.data_ptr(), bh, tq, tk, tk, d, patch,
        1.0 / (d ** 0.5), threshold, bq or 0, stream)
    build.check(err, "pssa_attention")
    LAUNCHES.bump()
    return out, nnz, xor_ones


def _band_fn(name: str):
    """The library's guard-band counter functions, bound on first use."""
    fn = getattr(build.library(), name)
    fn.argtypes = [ctypes.c_void_p] if name.endswith("count") else []
    fn.restype = ctypes.c_int
    return fn


def band_count() -> int:
    """Scores the kernel's guard band recomputed in fp32 since the last
    ``band_reset()``, summed over launches; read after they finished."""
    n = ctypes.c_ulonglong(0)
    build.check(_band_fn("pssa_attention_band_count")(ctypes.addressof(n)),
                "pssa_attention")
    return n.value


def band_reset() -> None:
    build.check(_band_fn("pssa_attention_band_reset")(), "pssa_attention")
