"""Per-layer PSSA/TIPS stats in config-derived order (port of
``repro.diffusion.stats``).

``UNetStats`` holds one ``PSSAStats`` and one ``TIPSResult`` per transformer
block, in ``attn_layer_order(cfg)``, and one ``ReuseRowCounters`` per block
when the forward ran with a temporal-reuse cache (none on the dense path).
A denoising loop collects one per step; ``UNetStats.stack`` turns the list
into the stacked view (every leaf gains a leading ``num_steps`` axis) and
``step(i)`` / ``unstack()`` go back.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.pssa import PSSAStats
from repro_torch.core.reuse import ReuseRowCounters
from repro_torch.core.tips import TIPSResult


@dataclasses.dataclass(frozen=True)
class LayerKey:
    """Static identity of one transformer block: tag + feature-map res."""
    tag: str
    resolution: int

    @property
    def name(self) -> str:
        return f"{self.tag}@{self.resolution}"


def attn_layer_order(cfg) -> Tuple[LayerKey, ...]:
    """Transformer blocks in forward-traversal order (mirrors
    ``unet_forward``): down stages, optional mid block, up stages."""
    order = []
    nstages = len(cfg.block_channels)
    for i, has_attn in enumerate(cfg.down_attn):
        if not has_attn:
            continue
        for r in range(cfg.resnets_per_down):
            order.append(LayerKey(f"down{i}.{r}", cfg.latent_size >> i))
    if cfg.has_mid_block:
        order.append(LayerKey("mid", cfg.latent_size >> (nstages - 1)))
    for j, i in enumerate(reversed(range(nstages))):
        if not cfg.down_attn[i]:
            continue
        for r in range(cfg.resnets_per_up):
            order.append(LayerKey(f"up{j}.{r}", cfg.latent_size >> i))
    return tuple(order)


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
        if not len(layers) == len(pssa) == len(tips):
            raise ValueError(f"{len(layers)} layers, {len(pssa)} PSSA and "
                             f"{len(tips)} TIPS entries")
        if reuse and len(reuse) != len(layers):
            raise ValueError(f"{len(layers)} layers, {len(reuse)} reuse "
                             f"entries")
        return cls(layers=layers, pssa=pssa, tips=tips, reuse=reuse)


def coerce_per_step_stats(stats) -> list:
    """A stacked ``UNetStats`` or a list of per-step ones -> a list."""
    if isinstance(stats, UNetStats):
        return stats.unstack()
    return list(stats)
