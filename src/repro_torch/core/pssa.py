"""PSSA byte accounting (port of ``repro.core.pssa``).

Prune post-softmax scores at a fixed threshold, XOR adjacent bitmap patches
along the key axis, and count the exact compressed sizes.  Counters are
summed as integers; the byte arithmetic then runs in float32, in the same
order as the JAX package with x64 off, so equal counters give bit-equal
``PSSAStats``.  ``exact_byte_counts`` is the exact Python-int ground truth.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.launch import mesh as mesh_mod

DEFAULT_THRESHOLD = 1.0 / 8192.0


class PSSAStats(NamedTuple):
    """Byte-exact accounting of one SAS compression (float32 scalars)."""
    nnz: torch.Tensor
    total: torch.Tensor
    bitmap_ones_raw: torch.Tensor
    bitmap_ones_xor: torch.Tensor
    bytes_baseline: torch.Tensor
    bytes_values: torch.Tensor
    bytes_index_csr_global: torch.Tensor
    bytes_index_rle: torch.Tensor
    bytes_index_pssa: torch.Tensor
    bytes_pssa_total: torch.Tensor


def prune(sas: torch.Tensor, threshold=DEFAULT_THRESHOLD) -> torch.Tensor:
    """Unstructured threshold pruning of post-softmax scores."""
    return torch.where(sas >= threshold, sas, torch.zeros((), dtype=sas.dtype,
                                                          device=sas.device))


def bitmap(sas_pruned: torch.Tensor) -> torch.Tensor:
    return sas_pruned != 0.0


def patch_xor(bm: torch.Tensor, patch: int) -> torch.Tensor:
    """XOR adjacent bitmap patches along the key (last) axis; the first
    patch column is kept verbatim."""
    tk = bm.shape[-1]
    if tk % patch:
        raise ValueError(f"key length {tk} is not a multiple of patch {patch}")
    r = bm.reshape(*bm.shape[:-1], tk // patch, patch)
    delta = torch.logical_xor(r[..., 1:, :], r[..., :-1, :])
    return torch.cat([r[..., :1, :], delta], dim=-2).reshape(bm.shape)


def patch_unxor(delta_bm: torch.Tensor, patch: int) -> torch.Tensor:
    """Inverse of :func:`patch_xor`: a cumulative XOR over the patch
    columns (the parity of a running count, exact)."""
    tk = delta_bm.shape[-1]
    r = delta_bm.reshape(*delta_bm.shape[:-1], tk // patch, patch)
    out = torch.remainder(torch.cumsum(r.to(torch.int32), dim=-2), 2) != 0
    return out.reshape(delta_bm.shape)


def index_bit_widths(tq: int, tk: int, patch: int) -> dict:
    """Static field widths of the three index formats (exact Python ints)."""
    return {
        "col_bits_global": max(1, math.ceil(math.log2(tk))),
        "ptr_bits_global": max(1, math.ceil(math.log2(tq * tk + 1))),
        "run_bits": max(1, math.ceil(math.log2(tk))),
        "col_bits_local": max(1, math.ceil(math.log2(patch))),
        "ptr_bits_local": max(1, math.ceil(math.log2(patch * patch + 1))),
    }


def exact_byte_counts(nnz: int, ones_xor: int, lead: int, tq: int, tk: int,
                      patch: int, value_bits: int = 12) -> dict:
    """Byte accounting from integer counters in exact Python arithmetic."""
    w = index_bit_widths(tq, tk, patch)
    total = lead * tq * tk
    n_tiles = lead * (tq // patch) * (tk // patch)
    return {
        "total": total,
        "bytes_baseline": total * value_bits / 8.0,
        "bytes_values": nnz * value_bits / 8.0,
        "bytes_index_csr_global": (nnz * w["col_bits_global"]
                                   + lead * (tq + 1)
                                   * w["ptr_bits_global"]) / 8.0,
        "bytes_index_rle": nnz * w["run_bits"] / 8.0,
        "bytes_index_pssa": (ones_xor * w["col_bits_local"]
                             + n_tiles * (patch + 1)
                             * w["ptr_bits_local"]) / 8.0,
    }


def _counters(bm: torch.Tensor, patch: int):
    """(nnz, ones_xor) int64 sums of a keep bitmap (..., Tq, Tk)."""
    tk = bm.shape[-1]
    if tk % patch:
        raise ValueError(f"key length {tk} is not a multiple of patch {patch}")
    r = bm.reshape(*bm.shape[:-1], tk // patch, patch)
    nnz = bm.sum(dtype=torch.int64)
    ones_xor = (r[..., 0, :].sum(dtype=torch.int64)
                + torch.logical_xor(r[..., 1:, :], r[..., :-1, :])
                .sum(dtype=torch.int64))
    return nnz, ones_xor


def compress_stats(sas: torch.Tensor, patch: int,
                   threshold=DEFAULT_THRESHOLD,
                   value_bits: int = 12) -> PSSAStats:
    """Exact compressed sizes for one SAS of shape (..., Tq, Tk); leading
    axes (heads, batch) are folded into the totals."""
    nnz, ones_xor = _counters(bitmap(prune(sas, threshold)), patch)
    return _assemble_stats(nnz, ones_xor, sas.shape, patch, value_bits)


class PSSARowCounters(NamedTuple):
    """Per-batch-row integer PSSA counters (slot serving).

    ``nnz`` / ``ones_xor`` are (B,) int64: each row's surviving-score
    count and patch-XOR bitmap population, heads and query rows folded.
    Summing any subset of rows gives :func:`compress_stats`' folded
    counters for that subset exactly, so a slot runtime can scatter rows
    into per-iteration buckets and still assemble bit-equal byte stats.
    """
    nnz: torch.Tensor
    ones_xor: torch.Tensor


def row_counters(sas: torch.Tensor, patch: int,
                 threshold=DEFAULT_THRESHOLD) -> PSSARowCounters:
    """Per-row counters of one SAS (B, ..., Tq, Tk): the same pruning,
    bitmap and XOR arithmetic as :func:`compress_stats`, reduced over
    every axis but the leading batch axis."""
    bm = bitmap(prune(sas, threshold))
    tk = bm.shape[-1]
    if tk % patch:
        raise ValueError(f"key length {tk} is not a multiple of patch {patch}")
    r = bm.reshape(*bm.shape[:-1], tk // patch, patch)
    nnz = bm.sum(dim=tuple(range(1, bm.ndim)), dtype=torch.int64)
    first = r[..., 0, :].sum(dim=tuple(range(1, bm.ndim)), dtype=torch.int64)
    delta = torch.logical_xor(r[..., 1:, :], r[..., :-1, :]).sum(
        dim=tuple(range(1, r.ndim)), dtype=torch.int64)
    return PSSARowCounters(nnz=nnz, ones_xor=first + delta)


def compress_stats_reference(sas: torch.Tensor, patch: int,
                             threshold=DEFAULT_THRESHOLD,
                             value_bits: int = 12) -> PSSAStats:
    """Materialize the full patch-XOR delta bitmap, then count (the seed
    oracle ``compress_stats`` is held against)."""
    bm = bitmap(prune(sas, threshold))
    nnz = bm.sum(dtype=torch.int64)
    ones_xor = patch_xor(bm, patch).sum(dtype=torch.int64)
    return _assemble_stats(nnz, ones_xor, sas.shape, patch, value_bits)


def _assemble_stats(nnz, ones_xor, shape, patch: int,
                    value_bits: int) -> PSSAStats:
    """Float32 byte arithmetic from integer counters.

    Mirrors ``repro.core.pssa._assemble_stats`` with x64 off operation for
    operation: the counters are converted to float32 once, every static
    quantity is an exact Python number rounded to float32 once.

    Under an active mesh (``launch.mesh.use_mesh``) the counters and the
    leading rows are summed over the data group as int64 first, so the
    stats are the global batch's: the shape terms are then exact int64
    tensors, rounded to float32 once as the Python numbers are.
    """
    tq, tk = shape[-2], shape[-1]
    lead = 1
    for s in shape[:-2]:
        lead *= s
    f32 = torch.float32
    dev = nnz.device
    if mesh_mod.active_mesh() is not None:
        nnz, ones_xor, lead = mesh_mod.data_sum(torch.stack([
            nnz.to(torch.int64), ones_xor.to(torch.int64),
            torch.full((), lead, dtype=torch.int64, device=dev)]))
    nnz = nnz.to(f32)
    ones_xor = ones_xor.to(f32)

    w = index_bit_widths(tq, tk, patch)
    total_i = lead * tq * tk
    n_tiles = lead * (tq // patch) * (tk // patch)

    def const(num, den=1.0):
        # num / den rounded to float32 once; num an exact integer
        if isinstance(num, torch.Tensor):
            return (num.to(torch.float64) / den).to(f32)
        return torch.tensor(num / den, dtype=f32, device=dev)

    total = const(total_i)
    bytes_baseline = const(total_i * value_bits, 8.0)
    ptr_global = const(lead * (tq + 1) * w["ptr_bits_global"], 8.0)
    ptr_local = const(n_tiles * (patch + 1) * w["ptr_bits_local"], 8.0)

    bytes_values = nnz * value_bits / 8.0
    bytes_csr = nnz * const(w["col_bits_global"] / 8.0) + ptr_global
    bytes_rle = nnz * const(w["run_bits"] / 8.0)
    bytes_pssa_idx = ones_xor * const(w["col_bits_local"] / 8.0) + ptr_local

    return PSSAStats(
        nnz=nnz, total=total,
        bitmap_ones_raw=nnz, bitmap_ones_xor=ones_xor,
        bytes_baseline=bytes_baseline,
        bytes_values=bytes_values,
        bytes_index_csr_global=bytes_csr,
        bytes_index_rle=bytes_rle,
        bytes_index_pssa=bytes_pssa_idx,
        bytes_pssa_total=bytes_values + bytes_pssa_idx,
    )


def stats_from_counters(nnz: torch.Tensor, ones_xor: torch.Tensor,
                        lead: int, tq: int, tk: int, patch: int,
                        value_bits: int = 12) -> PSSAStats:
    """``PSSAStats`` from integer counters accumulated by the fused kernel;
    shares the byte arithmetic with :func:`compress_stats`."""
    return _assemble_stats(nnz, ones_xor, (lead, tq, tk), patch, value_bits)


def compress_decompress(sas: torch.Tensor, patch: int,
                        threshold=DEFAULT_THRESHOLD) -> torch.Tensor:
    """Losslessness check: prune -> bitmap -> XOR -> un-XOR -> re-mask.
    Returns the reconstructed pruned SAS, equal to ``prune(sas)``."""
    pruned = prune(sas, threshold)
    bm2 = patch_unxor(patch_xor(bitmap(pruned), patch), patch)
    return torch.where(bm2, pruned, torch.zeros((), dtype=pruned.dtype,
                                                device=pruned.device))


def ema_reduction(stats: PSSAStats) -> torch.Tensor:
    """Fractional EMA reduction of the SAS against the uncompressed
    baseline."""
    return 1.0 - stats.bytes_pssa_total / stats.bytes_baseline
