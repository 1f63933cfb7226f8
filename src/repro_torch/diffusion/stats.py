"""Per-layer PSSA/TIPS stats in config-derived order (port of
``repro.diffusion.stats``).

``UNetStats`` holds one ``PSSAStats`` and one ``TIPSResult`` per transformer
block, in ``attn_layer_order(cfg)``, and one ``ReuseRowCounters`` per block
when the forward ran with a temporal-reuse cache (none on the dense path).
A denoising loop collects one per step; ``UNetStats.stack`` turns the list
into the stacked view (every leaf gains a leading ``num_steps`` axis) and
``step(i)`` / ``unstack()`` go back.

Slot serving (rows at different denoising steps in one call) uses
``SlotStats`` instead: per-layer PER-ROW integer counters, which
``LedgerAccum`` scatters into per-iteration (or per-(policy, step))
integer buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.pssa import PSSARowCounters, PSSAStats
from repro_torch.core.reuse import ReuseRowCounters
from repro_torch.core.tips import TIPSResult, TIPSRowCounters


@dataclasses.dataclass(frozen=True)
class LayerKey:
    """Static identity of one transformer block: tag + feature-map res."""
    tag: str
    resolution: int

    @property
    def name(self) -> str:
        return f"{self.tag}@{self.resolution}"


def attn_layer_order(cfg) -> Tuple[LayerKey, ...]:
    """Transformer blocks in forward-traversal order: the canonical order
    of every stats object, ``LedgerAccum`` column and reuse-cache layer,
    from the denoiser config's ``layer_order()`` hook."""
    return cfg.layer_order()


def _map(fn, nt):
    return type(nt)(*(fn(x) for x in nt))


@dataclasses.dataclass(frozen=True)
class UNetStats:
    """Per-layer stats; leaves are scalars (per-query arrays for TIPS,
    per-row counters for reuse) for one forward pass, with a leading
    ``num_steps`` axis when stacked."""
    layers: Tuple[LayerKey, ...]
    pssa: Tuple[PSSAStats, ...]
    tips: Tuple[TIPSResult, ...]
    reuse: Tuple[ReuseRowCounters, ...] = ()

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def num_steps(self) -> int:
        """Leading (stacked) axis length; 0 for a single pass."""
        if not self.pssa:
            return 0
        lead = self.pssa[0].nnz
        return int(lead.shape[0]) if lead.ndim >= 1 else 0

    def map(self, fn) -> "UNetStats":
        return UNetStats(layers=self.layers,
                         pssa=tuple(_map(fn, s) for s in self.pssa),
                         tips=tuple(_map(fn, t) for t in self.tips),
                         reuse=tuple(_map(fn, r) for r in self.reuse))

    def step(self, i: int) -> "UNetStats":
        """Per-iteration view of a stacked stats object."""
        return self.map(lambda x: x[i])

    def unstack(self) -> list:
        n = self.num_steps
        return [self] if n == 0 else [self.step(i) for i in range(n)]

    def as_dict(self) -> dict:
        """The seed's ``{"pssa": {...}, "tips": {...}}`` string-keyed view."""
        return {
            "pssa": {k.name: s for k, s in zip(self.layers, self.pssa)},
            "tips": {k.name: t for k, t in zip(self.layers, self.tips)},
        }

    def cpu(self) -> "UNetStats":
        """Host copy (the ledger reads scalars on the host)."""
        return self.map(lambda x: x.cpu())

    @classmethod
    def stack(cls, per_step: list) -> "UNetStats":
        """List of single-pass stats -> one stacked stats object."""
        first = per_step[0]

        def stacked(kind, field):
            return tuple(
                kind(*(torch.stack(f) for f in zip(
                    *[getattr(s, field)[li] for s in per_step])))
                for li in range(len(getattr(first, field))))
        return cls(layers=first.layers,
                   pssa=stacked(PSSAStats, "pssa"),
                   tips=stacked(TIPSResult, "tips"),
                   reuse=stacked(ReuseRowCounters, "reuse"))

    @classmethod
    def from_layer_list(cls, layers, pssa, tips, reuse=()) -> "UNetStats":
        layers, pssa, tips = tuple(layers), tuple(pssa), tuple(tips)
        reuse = tuple(reuse)
        _check_lengths(layers, pssa, tips, reuse)
        return cls(layers=layers, pssa=pssa, tips=tips, reuse=reuse)


def _check_lengths(layers, pssa, tips, reuse):
    if not len(layers) == len(pssa) == len(tips):
        raise ValueError(f"{len(layers)} layers, {len(pssa)} PSSA and "
                         f"{len(tips)} TIPS entries")
    if reuse and len(reuse) != len(layers):
        raise ValueError(f"{len(layers)} layers, {len(reuse)} reuse "
                         f"entries")


@dataclasses.dataclass(frozen=True)
class SlotStats:
    """Per-layer PER-ROW integer counters (slot serving).

    The same static layer order as ``UNetStats``, but each layer carries a
    ``PSSARowCounters`` and a ``TIPSRowCounters`` whose leaves are (B,)
    int64, one entry per batch row.  Integer addition is exact and
    associative, so scattering rows into ``LedgerAccum`` buckets in any
    order reproduces the one-shot folded counters bit for bit.
    """
    layers: Tuple[LayerKey, ...]
    pssa: Tuple[PSSARowCounters, ...]
    tips: Tuple[TIPSRowCounters, ...]
    reuse: Tuple[ReuseRowCounters, ...] = ()

    def counter_matrices(self):
        """(nnz, ones_xor, important), each (B, L) in ``layers`` order."""
        return (torch.stack([c.nnz for c in self.pssa], dim=1),
                torch.stack([c.ones_xor for c in self.pssa], dim=1),
                torch.stack([t.important for t in self.tips], dim=1))

    def reuse_counter_matrices(self):
        """(computed, total), each (B, L), or None on the dense path."""
        if not self.reuse:
            return None
        return (torch.stack([r.computed for r in self.reuse], dim=1),
                torch.stack([r.total for r in self.reuse], dim=1))

    @classmethod
    def from_layer_list(cls, layers, pssa, tips, reuse=()) -> "SlotStats":
        layers, pssa, tips = tuple(layers), tuple(pssa), tuple(tips)
        reuse = tuple(reuse)
        _check_lengths(layers, pssa, tips, reuse)
        return cls(layers=layers, pssa=pssa, tips=tips, reuse=reuse)


def _bucket_add(plane, idx, vals):
    """``plane`` with ``vals`` rows added at bucket ``idx``; rows whose
    bucket is out of range land in a sink row that is sliced off, so they
    can never bleed into another bucket."""
    n = plane.shape[0]
    sink = torch.zeros((1,) + tuple(plane.shape[1:]), dtype=plane.dtype,
                       device=plane.device)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    return torch.cat([plane, sink]).index_add_(0, idx, vals)[:n]


@dataclasses.dataclass(frozen=True)
class LedgerAccum:
    """Per-iteration integer ledger buckets for slot serving.

    One row per bucket (a denoising iteration, or ``policy * N + step``
    under a sampler bank), one column per transformer block in
    ``attn_layer_order``: ``nnz`` / ``ones_xor`` are the PSSA counters,
    ``imp`` the TIPS important-token counts, ``rows`` the accounted
    (active) request rows that ran the bucket, and ``reuse_computed`` /
    ``reuse_total`` the temporal-reuse patch counters.  Every plane is
    int64: at full width one request adds up to 8 heads x 4096^2 to a
    res-64 layer's ``nnz`` bucket, so 16 requests at one bucket pass
    2^31 (the JAX package keeps int32 without x64; ROADMAP Queue 3).
    """
    nnz: torch.Tensor             # (num_buckets, L) int64
    ones_xor: torch.Tensor        # (num_buckets, L) int64
    imp: torch.Tensor             # (num_buckets, L) int64
    rows: torch.Tensor            # (num_buckets,) int64
    reuse_computed: torch.Tensor  # (num_buckets, L) int64
    reuse_total: torch.Tensor     # (num_buckets, L) int64

    @classmethod
    def zeros(cls, num_buckets: int, num_layers: int,
              device="cpu") -> "LedgerAccum":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)
        return cls(nnz=z(num_buckets, num_layers),
                   ones_xor=z(num_buckets, num_layers),
                   imp=z(num_buckets, num_layers), rows=z(num_buckets),
                   reuse_computed=z(num_buckets, num_layers),
                   reuse_total=z(num_buckets, num_layers))

    def scatter(self, bucket: torch.Tensor, active: torch.Tensor,
                slot_stats: SlotStats) -> "LedgerAccum":
        """Add one slot step's per-row counters into their buckets.

        ``bucket`` (B,) is each row's bucket for the step just run;
        ``active`` (B,) masks unoccupied slots, whose counters are zeroed
        BEFORE the add, so occupancy can never move a bucket.  Rows with
        an out-of-range bucket are dropped.
        """
        gate = active.to(torch.int64)[:, None]
        nnz, ones_xor, imp = (m.to(torch.int64) * gate
                              for m in slot_stats.counter_matrices())
        reuse = slot_stats.reuse_counter_matrices()
        if reuse is None:
            computed, total = self.reuse_computed, self.reuse_total
        else:
            computed = _bucket_add(self.reuse_computed, bucket,
                                   reuse[0].to(torch.int64) * gate)
            total = _bucket_add(self.reuse_total, bucket,
                                reuse[1].to(torch.int64) * gate)
        return LedgerAccum(
            nnz=_bucket_add(self.nnz, bucket, nnz),
            ones_xor=_bucket_add(self.ones_xor, bucket, ones_xor),
            imp=_bucket_add(self.imp, bucket, imp),
            rows=_bucket_add(self.rows, bucket, active.to(torch.int64)),
            reuse_computed=computed, reuse_total=total)


def coerce_per_step_stats(stats) -> list:
    """A stacked ``UNetStats`` or a list of per-step ones -> a list."""
    if isinstance(stats, UNetStats):
        return stats.unstack()
    return list(stats)
