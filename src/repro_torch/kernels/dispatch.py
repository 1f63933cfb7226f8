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

The compiled-path policy is the JAX package's too: ``ffn_quant="int8"``
runs the DBSC integer matmuls as int8 x int8 -> int32 library products
(the same integers), and ``tuned`` (the ``autotuned`` preset) launches the
kernels with ``kernels.autotune``'s table winners, per op and geometry.
The winners are CUDA launch dimensions under the JAX package's knob names
(``autotune.OP_KNOBS``).  The JAX package's five block fields are not
ported: their defaults (128, 128, 128, 64 and 8) are Pallas tile sizes
that mean nothing to these kernels, and no spec sets them.  An untuned
policy, and a geometry the table lacks, launch each kernel by its own
launch rule.  No knob moves a bit.  There is no interpreter on the card,
so ``interpret=`` raises.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import attention, tips
from repro_torch.kernels import autotune
from repro_torch.kernels.bitslice_matmul.ops import (QUANT_PATHS,
                                                   bitslice_matmul)
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
_PRESETS = ("reference", "fused", "auto", "autotuned")
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
    # tuned=True: the kernels launch with the autotune table's winners,
    # looked up per (device type, op, geometry) from the operand shapes on
    # the host (``kernels.autotune.lookup``)
    tuned: bool = False
    # ffn_quant="int8": the DBSC route's integer matmuls run as int8 x int8
    # -> int32 library products instead of the model's datapath; the
    # integers are bit-identical
    ffn_quant: str = "model"

    def __post_init__(self):
        for op, allowed in _CHOICES.items():
            val = getattr(self, op)
            if val not in allowed:
                raise ValueError(
                    f"KernelPolicy.{op}={val!r}: expected one of {allowed}")
        if self.ffn_quant not in QUANT_PATHS:
            raise ValueError(
                f"KernelPolicy.ffn_quant={self.ffn_quant!r}: expected one "
                f"of {QUANT_PATHS}")

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
    def autotuned(cls) -> "KernelPolicy":
        """``fused()`` with the autotune table's launch knobs.

        The knobs come from ``kernels.autotune.lookup`` per (device type,
        op, geometry); a geometry the table has not seen keeps the
        kernels' launch rules, so the preset is always safe to select.
        Routing is ``fused()``'s, and no knob moves a bit.
        """
        return dataclasses.replace(cls.fused(), tuned=True)

    @classmethod
    def parse(cls, spec: str, device=None) -> "KernelPolicy":
        """Build a policy from a CLI spec (the ``--kernels`` flag).

        ``spec`` is a preset (``reference`` | ``fused`` | ``auto`` |
        ``autotuned``, ``auto`` resolved for ``device``) or comma-separated
        ``op=impl`` / ``tuned={true,false}`` / ``ffn_quant={model,int8}``
        overrides on top of the reference preset, e.g.
        ``"self_attention=fused,ffn=dbsc,ffn_quant=int8"``.  The JAX
        package's ``interpret=`` raises: the kernels are CUDA and have no
        interpreter, and no spec maps silently onto another.
        """
        spec = spec.strip()
        if spec == "auto":
            return cls.auto(device)
        if spec in _PRESETS:
            return getattr(cls, spec)()
        fields = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if "=" not in item:
                raise ValueError(
                    f"kernel policy spec {item!r}: expected op=impl or a "
                    f"preset in {_PRESETS}")
            op, impl = (s.strip() for s in item.split("=", 1))
            if op == "ffn_quant" or op in _CHOICES:
                fields[op] = impl
            elif op == "tuned":
                try:
                    fields[op] = {"true": True, "false": False}[impl.lower()]
                except KeyError:
                    raise ValueError(
                        f"kernel policy spec: tuned={impl!r} (expected "
                        f"true or false)") from None
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
        ``None``: the card).
        """
        return {**{op: getattr(self, op) for op in _CHOICES},
                "backend": torch.device(
                    "cuda" if device is None else device).type,
                "tuned": self.tuned,
                "ffn_quant": self.ffn_quant}


def _blocks(policy: KernelPolicy, op: str, geom: tuple, device) -> dict:
    """The launch knobs of one dispatch call: the autotune table's winner
    for this (device type, op, geometry) when ``policy.tuned``, else none
    (``{}``: each kernel's launch rule).  ``geom`` comes from shapes, so
    the lookup runs on the host with no device sync; the table is read
    once (``autotune.load_table`` memoises it).  The CPU has no entries,
    and the plain versions take no knob."""
    if not policy.tuned:
        return {}
    return autotune.lookup(op, geom,
                           backend=torch.device(device).type) or {}


def _ffn_mid_covered(precision, important):
    return (important is not None and precision is not None
            and precision.ffn_mid)


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _ffn_reference(policy, hn, p, important, precision=None):
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


def _ffn_dbsc(policy, hn, p, important, precision=None):
    """Both FFN matmuls through the DBSC bit-slice integer datapath; one
    per-tensor activation scale over the whole (B*T, C) matrix.
    ``policy.ffn_quant`` picks how the integer matmuls run (the same
    integers either way, so no counter or ledger term moves)."""
    b, t, c = hn.shape
    bt = b * t
    imp_flat = important.reshape(bt) if important is not None else None
    gu = bitslice_matmul(hn.reshape(bt, c), p["ff_geglu"]["w"],
                         important=imp_flat,
                         quant_path=policy.ffn_quant).reshape(b, t, -1) \
        + p["ff_geglu"]["b"]
    g, u = torch.chunk(gu, 2, dim=-1)
    mid = _gelu(g) * u
    mid_imp = imp_flat if _ffn_mid_covered(precision, important) else None
    return bitslice_matmul(mid.reshape(bt, mid.shape[-1]), p["ff_out"]["w"],
                           important=mid_imp,
                           quant_path=policy.ffn_quant).reshape(b, t, c) \
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
        blk = _blocks(policy, "self_attention", (*q.shape, patch), q.device)
        return attention.self_attention_pssa_fused(
            q, k, v, patch=patch, threshold=threshold, stats_rows=stats_rows,
            bq=blk.get("attn_block_q"), row_stats=row_stats)
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
        blk = _blocks(policy, "cross_attention",
                      (*q.shape, k_text.shape[2]), q.device)
        return attention.cross_attention_tips_fused(
            q, k_text, v_text, precision=precision, stats_rows=stats_rows,
            bq=blk.get("cross_block_q"), row_stats=row_stats,
            threshold_scale=threshold_scale)
    return attention.cross_attention_tips(
        q, k_text, v_text, precision=precision, stats_rows=stats_rows,
        row_stats=row_stats, threshold_scale=threshold_scale)


def ffn_geglu(policy: KernelPolicy, hn, p, important, precision=None):
    """(B, T, C) normed hidden -> (B, T, C) FFN output (pre-residual)."""
    return _FFN[policy.ffn](policy, hn, p, important, precision)


def patch_bitmap(policy: KernelPolicy, sas, patch: int, threshold: float):
    """PSXU payload op: (..., Tq, Tk) SAS -> packed XOR bitmap
    (..., Tq, Tk/32) uint32 and per-patch popcounts (..., Tq, Tk/patch)."""
    if policy.bitmap == "kernel":
        tk = sas.shape[-1]
        blk = _blocks(policy, "bitmap", (sas.numel() // tk, tk, patch),
                      sas.device)
        return _patch_bitmap_op(sas, patch, threshold, use_kernel=True,
                                br=blk.get("bitmap_block_rows"))
    return _patch_bitmap_op(sas, patch, threshold, use_kernel=False)


def patch_delta(policy: KernelPolicy, x, x_ref, *, patch: int,
                threshold: float):
    """Temporal-reuse change detection via the policy's implementation.

    (B, T, C) tokens vs cached reference -> ((B, P) float32 max-abs patch
    delta, (B, P) bool active bitmap).  Both routes take the max over the
    same values, so the bitmap and every reuse counter downstream are
    bit-identical across routing.
    """
    if policy.reuse == "kernel":
        blk = _blocks(policy, "reuse", (*x.shape, patch), x.device)
        return _patch_delta_op(x, x_ref, patch=patch, threshold=threshold,
                               use_kernel=True,
                               bp=blk.get("reuse_block_patches"))
    return _patch_delta_op(x, x_ref, patch=patch, threshold=threshold,
                           use_kernel=False)


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
