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

The JAX package's block-size knobs, its autotune table and its
``ffn_quant="int8"`` route are not ported yet: their specs raise in
``KernelPolicy.parse`` (ROADMAP.md, Queue 1 items 3 and 5), and there is
no interpreter on the card, so ``interpret=`` raises too.
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
_PRESETS = ("reference", "fused", "auto")
# the hand-written kernel behind each non-reference implementation
_KERNELS = {
    ("self_attention", "fused"): "pssa_attention",
    ("cross_attention", "fused"): "cross_attention_tips",
    ("ffn", "dbsc"): "bitslice_matmul",
    ("bitmap", "kernel"): "patch_bitmap",
    ("reuse", "kernel"): "patch_delta",
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
        """``fused`` when ``device`` (``None``: the card) is the card,
        ``reference`` on the CPU, as the JAX package's ``auto`` picks by
        backend.  The FFN stays on the float reference either way: DBSC
        is an explicit choice (``ffn=dbsc``)."""
        if resolve_device(device).type == "cuda":
            return cls.fused()
        return cls.reference()

    @classmethod
    def parse(cls, spec: str, device=None) -> "KernelPolicy":
        """Build a policy from a CLI spec (the ``--kernels`` flag).

        ``spec`` is a preset (``reference`` | ``fused`` | ``auto``, the
        last resolved for ``device``) or comma-separated ``op=impl``
        overrides on top of the reference preset, e.g.
        ``"self_attention=fused,ffn=dbsc"``.  The JAX package's
        ``autotuned``, ``tuned=``, ``ffn_quant=int8`` and ``interpret=``
        raise: the port has no such route yet, and no spec maps silently
        onto another.
        """
        spec = spec.strip()
        if spec == "auto":
            return cls.auto(device)
        if spec in _PRESETS:
            return getattr(cls, spec)()
        if spec == "autotuned":
            raise ValueError(
                "kernel policy 'autotuned': the port has no autotune "
                "table yet (ROADMAP.md, Queue 1 item 3)")
        fields = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"kernel policy spec {item!r}: expected op=impl or a "
                    f"preset in {_PRESETS}")
            op, impl = (s.strip() for s in item.split("=", 1))
            if op in _CHOICES:
                fields[op] = impl
            elif op == "tuned":
                raise ValueError(
                    f"kernel policy spec: tuned={impl!r}: the port has no "
                    f"autotune table yet (ROADMAP.md, Queue 1 item 3)")
            elif op == "ffn_quant":
                if impl != "model":
                    raise ValueError(
                        f"kernel policy spec: ffn_quant={impl!r}: the port "
                        f"runs the FFN's integers as the model's datapath "
                        f"only ('model'); the int8 route is ROADMAP.md, "
                        f"Queue 1 item 5")
            elif op == "interpret":
                raise ValueError(
                    f"kernel policy spec: interpret={impl!r}: the kernels "
                    f"are CUDA and have no interpreter; a CPU tensor takes "
                    f"their plain versions")
            else:
                raise ValueError(f"kernel policy spec: unknown op {op!r} "
                                 f"(expected {tuple(_CHOICES)})")
        return cls(**fields)

    def describe(self, device=None) -> dict:
        """JSON-friendly view for serving metrics and records.

        ``backend`` is the device type the policy runs on (``device``,
        ``None``: the card); ``tuned`` and ``ffn_quant`` carry the only
        values the port has.
        """
        return {**{op: getattr(self, op) for op in _CHOICES},
                "backend": torch.device(
                    "cuda" if device is None else device).type,
                "tuned": False,
                "ffn_quant": "model"}


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


def support_matrix() -> list:
    """op x impl rows: on the card (``cuda``) a non-reference
    implementation runs its sm_90a kernel, on the CPU (``cpu``) that
    kernel's plain PyTorch version; the reference runs native ops on
    either."""
    rows = []
    for op, impls in _CHOICES.items():
        for impl in impls:
            kernel = _KERNELS.get((op, impl))
            rows.append({
                "op": op, "impl": impl, "kernel": kernel,
                "cuda": (f"sm_90a kernel (csrc/{kernel}.cu)" if kernel
                         else "native"),
                "cpu": "plain PyTorch version" if kernel else "native",
            })
    return rows
