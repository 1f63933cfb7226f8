"""Kernel dispatch: one policy object routes every hot-path op (port of
``repro.kernels.dispatch``).

  self_attention   reference | fused    PSSA-pruned self-attention + stats
  cross_attention  reference | fused    text cross-attention + TIPS CAS
  ffn              reference | dbsc     GEGLU FFN (TIPS mixed precision)
  bitmap           reference | kernel   PSXU bitmap / patch-XOR / popcount
  reuse            reference | kernel   temporal-reuse patch delta

``fused``, ``dbsc`` and ``kernel`` run the hand-written kernels on a CUDA
tensor and their plain PyTorch versions on a CPU tensor.  Stats parity
(DESIGN.md §5): for any policy the reported counters equal the reference
path's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import attention, tips
from repro_torch.kernels.bitslice_matmul.ops import bitslice_matmul
from repro_torch.kernels.patch_bitmap.ops import (
    patch_bitmap as _patch_bitmap_op)
from repro_torch.kernels.patch_reuse.ops import patch_delta as _patch_delta_op
from repro_torch.kernels.runtime import resolve_device

_CHOICES = {
    "self_attention": ("reference", "fused"),
    "cross_attention": ("reference", "fused"),
    "ffn": ("reference", "dbsc"),
    "bitmap": ("reference", "kernel"),
    "reuse": ("reference", "kernel"),
}


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which implementation each hot-path op dispatches to."""
    self_attention: str = "reference"
    cross_attention: str = "reference"
    ffn: str = "reference"
    bitmap: str = "reference"
    reuse: str = "reference"

    def __post_init__(self):
        for op, allowed in _CHOICES.items():
            val = getattr(self, op)
            if val not in allowed:
                raise ValueError(
                    f"KernelPolicy.{op}={val!r}: expected one of {allowed}")

    @classmethod
    def reference(cls) -> "KernelPolicy":
        """Plain PyTorch everywhere (the materializing path)."""
        return cls()

    @classmethod
    def fused(cls) -> "KernelPolicy":
        """Both attentions, the PSXU bitmap and the patch delta through
        their kernels; the FFN stays on the float reference (DBSC is a
        precision feature, selected by ``ffn``)."""
        return cls(self_attention="fused", cross_attention="fused",
                   bitmap="kernel", reuse="kernel")

    @classmethod
    def auto(cls, device=None) -> "KernelPolicy":
        """``fused`` + ``dbsc`` when ``device`` is the card, else reference."""
        if resolve_device(device).type == "cuda":
            return dataclasses.replace(cls.fused(), ffn="dbsc")
        return cls.reference()


def _ffn_mid_covered(precision, important):
    return (important is not None and precision is not None
            and precision.ffn_mid)


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _ffn_reference(hn, p, important, precision=None):
    """GEGLU FFN, float matmuls; TIPS rows fake-quantized (per sample)."""
    if important is not None:
        hn = tips.apply_precision_mask(hn, important)
    gu = torch.einsum("btc,cd->btd", hn, p["ff_geglu"]["w"]) \
        + p["ff_geglu"]["b"]
    g, u = torch.chunk(gu, 2, dim=-1)
    mid = _gelu(g) * u
    if _ffn_mid_covered(precision, important):
        mid = tips.apply_precision_mask(mid, important)
    return torch.einsum("btd,dc->btc", mid, p["ff_out"]["w"]) \
        + p["ff_out"]["b"]


def _ffn_dbsc(hn, p, important, precision=None):
    """Both FFN matmuls through the DBSC bit-slice integer datapath; one
    per-tensor activation scale over the whole (B*T, C) matrix."""
    b, t, c = hn.shape
    bt = b * t
    imp_flat = important.reshape(bt) if important is not None else None
    gu = bitslice_matmul(hn.reshape(bt, c), p["ff_geglu"]["w"],
                         important=imp_flat).reshape(b, t, -1) \
        + p["ff_geglu"]["b"]
    g, u = torch.chunk(gu, 2, dim=-1)
    mid = _gelu(g) * u
    mid_imp = imp_flat if _ffn_mid_covered(precision, important) else None
    return bitslice_matmul(mid.reshape(bt, mid.shape[-1]), p["ff_out"]["w"],
                           important=mid_imp).reshape(b, t, c) \
        + p["ff_out"]["b"]


_FFN = {"reference": _ffn_reference, "dbsc": _ffn_dbsc}


def self_attention(policy: KernelPolicy, q, k, v, *, patch: int,
                   threshold, prune_scores: bool = True,
                   stats_rows: int | None = None,
                   reference_stats: bool = False,
                   row_stats: bool = False) -> attention.SelfAttnOut:
    """PSSA self-attention via the policy's implementation.

    Three combinations take the materializing reference whatever the
    policy: ``reference_stats`` (the seed stats oracle), ``prune_scores``
    False (the kernel always prunes), and a per-row ``threshold`` tensor
    (a bank that schedules ``pssa_scale``: the kernel takes one scalar
    threshold, as the JAX package's does).  ``row_stats`` reports per-row
    integer counters (``pssa.PSSARowCounters``), the same on every route.
    """
    impl = policy.self_attention
    per_row = isinstance(threshold, torch.Tensor) and threshold.ndim >= 1
    if impl == "fused" and (reference_stats or not prune_scores or per_row):
        impl = "reference"
    if impl == "fused":
        return attention.self_attention_pssa_fused(
            q, k, v, patch=patch, threshold=threshold, stats_rows=stats_rows,
            row_stats=row_stats)
    return attention.self_attention_pssa(
        q, k, v, patch=patch, threshold=threshold,
        prune_scores=prune_scores, stats_rows=stats_rows,
        reference_stats=reference_stats, row_stats=row_stats)


def cross_attention(policy: KernelPolicy, q, k_text, v_text, *,
                    precision, stats_rows: int | None = None,
                    row_stats: bool = False, threshold_scale=None
                    ) -> attention.CrossAttnOut:
    """Cross-attention + TIPS spotting via the policy's implementation.

    ``row_stats`` reports per-row important-token counts
    (``tips.TIPSRowCounters``); ``threshold_scale`` ((B,) or None) scales
    each row's spotting threshold downstream of both implementations.
    """
    if policy.cross_attention == "fused":
        return attention.cross_attention_tips_fused(
            q, k_text, v_text, precision=precision, stats_rows=stats_rows,
            row_stats=row_stats, threshold_scale=threshold_scale)
    return attention.cross_attention_tips(
        q, k_text, v_text, precision=precision, stats_rows=stats_rows,
        row_stats=row_stats, threshold_scale=threshold_scale)


def ffn_geglu(policy: KernelPolicy, hn, p, important, precision=None):
    """(B, T, C) normed hidden -> (B, T, C) FFN output (pre-residual)."""
    return _FFN[policy.ffn](hn, p, important, precision)


def patch_bitmap(policy: KernelPolicy, sas, patch: int, threshold: float):
    """PSXU payload op: (..., Tq, Tk) SAS -> packed XOR bitmap
    (..., Tq, Tk/32) uint32 and per-patch popcounts (..., Tq, Tk/patch)."""
    return _patch_bitmap_op(sas, patch, threshold,
                            use_kernel=policy.bitmap == "kernel")


def patch_delta(policy: KernelPolicy, x, x_ref, *, patch: int,
                threshold: float):
    """Temporal-reuse change detection via the policy's implementation.

    (B, T, C) tokens vs cached reference -> ((B, P) float32 max-abs patch
    delta, (B, P) bool active bitmap).  Both routes take the max over the
    same values, so the bitmap and every reuse counter downstream are
    bit-identical across routing.
    """
    return _patch_delta_op(x, x_ref, patch=patch, threshold=threshold,
                           use_kernel=policy.reuse == "kernel")
