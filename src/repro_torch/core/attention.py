"""Attention with the paper's features folded in (port of
``repro.core.attention``).

``self_attention_pssa``        — materializing PSSA self-attention (the
                                 paper's baseline dataflow and the stats
                                 oracle).
``self_attention_pssa_fused``  — the same contract through the PSSA kernel:
                                 the score matrix never exists in memory and
                                 the stats come from its integer counters.
``cross_attention_tips``       — materializing cross-attention + CAS.
``cross_attention_tips_fused`` — the same through the cross-attention
                                 kernel; spotting runs downstream on the
                                 head-averaged CAS, shared with the
                                 reference (``_spot_and_slice``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import pssa, precision as precision_mod, tips
from repro_torch.kernels.cross_attention_tips.ops import cross_attention_cas
from repro_torch.kernels.pssa_attention.ops import pssa_attention


class SelfAttnOut(NamedTuple):
    out: torch.Tensor
    stats: pssa.PSSAStats       # PSSARowCounters under ``row_stats``


def self_attention_pssa(q, k, v, patch: int,
                        threshold=pssa.DEFAULT_THRESHOLD,
                        prune_scores: bool = True,
                        stats_rows: int | None = None,
                        reference_stats: bool = False,
                        row_stats: bool = False) -> SelfAttnOut:
    """(B, H, T, d) q/k/v -> (B, H, T, d); scores pruned at ``threshold``.

    ``stats_rows`` limits the accounting to the first N batch rows (the
    cond half under fused CFG).  A (B,) ``threshold`` tensor prunes each
    batch row at its own threshold.  ``row_stats`` keeps the integer
    counters per row (``pssa.PSSARowCounters``) instead of folding them.
    """
    d = q.shape[-1]
    if isinstance(threshold, torch.Tensor) and threshold.ndim == 1:
        threshold = threshold.reshape(threshold.shape[0], 1, 1, 1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(float(d))
    probs = torch.softmax(scores, dim=-1)
    probs_used = pssa.prune(probs, threshold) if prune_scores else probs
    probs_stat = probs if stats_rows is None else probs[:stats_rows]
    thr_stat = threshold
    if (stats_rows is not None and isinstance(threshold, torch.Tensor)
            and threshold.ndim == 4):
        thr_stat = threshold[:stats_rows]
    if row_stats:
        stats = pssa.row_counters(probs_stat, patch, thr_stat)
    else:
        compress = (pssa.compress_stats_reference if reference_stats
                    else pssa.compress_stats)
        stats = compress(probs_stat, patch, thr_stat)
    out = torch.einsum("bhqk,bhkd->bhqd", probs_used, v)
    return SelfAttnOut(out=out, stats=stats)


def self_attention_pssa_fused(q, k, v, patch: int,
                              threshold: float = pssa.DEFAULT_THRESHOLD,
                              stats_rows: int | None = None,
                              bq: int | None = None,
                              row_stats: bool = False) -> SelfAttnOut:
    """``self_attention_pssa`` through the PSSA kernel (always prunes).

    The queries (B, H, Tq, d) may be fewer than the keys (B, H, Tk, d):
    under temporal reuse they are gathered to the active patch rows.
    ``bq`` is the kernel's query rows a block (``None``: its launch rule).
    ``row_stats`` folds the kernel's per-query counters over heads and
    queries only: (B, H, Tq) -> (B,) ``pssa.PSSARowCounters``.
    """
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    out, nnz_rows, xor_rows = pssa_attention(q, k, v, threshold, patch=patch,
                                             bq=bq)
    rows = b if stats_rows is None else stats_rows
    if row_stats:
        return SelfAttnOut(out=out, stats=pssa.PSSARowCounters(
            nnz=nnz_rows[:rows].sum(dim=(1, 2), dtype=torch.int64),
            ones_xor=xor_rows[:rows].sum(dim=(1, 2), dtype=torch.int64)))
    nnz = nnz_rows[:rows].sum(dtype=torch.int64)
    ones_xor = xor_rows[:rows].sum(dtype=torch.int64)
    stats = pssa.stats_from_counters(nnz, ones_xor, lead=rows * h,
                                     tq=tq, tk=tk, patch=patch)
    return SelfAttnOut(out=out, stats=stats)


class CrossAttnOut(NamedTuple):
    out: torch.Tensor
    tips_result: tips.TIPSResult   # reported stats (cond rows under CFG);
    #                                TIPSRowCounters under ``row_stats``
    important_full: torch.Tensor   # full-batch mask for the FFN precision


def _spot_and_slice(cas, precision, stats_rows: int | None,
                    row_stats: bool = False, threshold_scale=None):
    """Shared spotting tail of both cross-attention implementations.

    Returns (reported TIPSResult, full-batch importance mask); with
    ``stats_rows`` the reported stats cover the first N rows only.
    ``row_stats`` reports ``tips.TIPSRowCounters`` (each row's count of
    important tokens) instead; ``threshold_scale`` ((B,) or None) scales
    each row's spotting threshold (``precision.spot_cas``).
    """
    spotted = precision_mod.spot_cas(cas, precision,
                                     threshold_scale=threshold_scale)
    important_full = spotted.important
    if row_stats:
        imp = (spotted.important if stats_rows is None
               else spotted.important[:stats_rows])
        return (tips.TIPSRowCounters(
            important=imp.sum(dim=-1, dtype=torch.int64)), important_full)
    if stats_rows is not None:
        imp = spotted.important[:stats_rows]
        spotted = tips.TIPSResult(
            important=imp, cas=spotted.cas[:stats_rows],
            low_precision_ratio=tips.mask_low_precision_ratio(imp))
    return spotted, important_full


def cross_attention_tips(q, k_text, v_text, precision,
                         stats_rows: int | None = None,
                         row_stats: bool = False,
                         threshold_scale=None) -> CrossAttnOut:
    """(B, H, Tq, d) pixel queries x (B, H, Tk, d) text keys, with TIPS."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k_text) / math.sqrt(float(d))
    probs = torch.softmax(scores, dim=-1)
    cas = probs[..., :, precision.cls_index].mean(dim=-2)       # (B, Tq)
    spotted, important_full = _spot_and_slice(cas, precision, stats_rows,
                                              row_stats, threshold_scale)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v_text)
    return CrossAttnOut(out=out, tips_result=spotted,
                        important_full=important_full)


def cross_attention_tips_fused(q, k_text, v_text, precision,
                               stats_rows: int | None = None,
                               bq: int | None = None,
                               row_stats: bool = False,
                               threshold_scale=None) -> CrossAttnOut:
    """``cross_attention_tips`` through the cross-attention kernel; ``bq``
    its query rows a block (``None``: its launch rule)."""
    out, cas_bh = cross_attention_cas(q, k_text, v_text,
                                      cls_index=precision.cls_index, bq=bq)
    cas = cas_bh.mean(dim=-2)                                   # (B, Tq)
    spotted, important_full = _spot_and_slice(cas, precision, stats_rows,
                                              row_stats, threshold_scale)
    return CrossAttnOut(out=out, tips_result=spotted,
                        important_full=important_full)
