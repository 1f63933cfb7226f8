"""Bytes-accurate EMA + MAC ledger for the full BK-SDM-Tiny and DiT-S/2
geometries (copy of ``repro.diffusion.ledger``).

The paper's evaluation is energy / throughput / external-memory-access, so
the reproduction target is this ledger: it walks the exact UNet
architecture (``UNetConfig``, full size — no tensors allocated) and emits
one ``core.energy.LayerTraffic`` entry per layer per iteration:

  * activations INT12 (1.5 B/elem), weights INT8 (1 B/elem) — the paper's
    operating precision;
  * the self-attention score (SAS) is written to DRAM after softmax and read
    back for the PV matmul (the attention core's dataflow) — 2x traffic,
    which is what PSSA compresses;
  * FFN MACs split INT12/INT6 by the TIPS low-precision ratio;
  * the 192 KB global memory cannot hold a 64x64 feature map, so every
    layer's activations round-trip DRAM (the paper's 1.9 GB/iter premise).

Measured quantities (PSSA compression ratio per resolution, TIPS ratio per
iteration) come from the runtime and are injected through
``LedgerOptions`` — the ledger itself stays exact arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.core.energy import EnergyReport, LayerTraffic, report
from repro_torch.diffusion.denoiser import family_of
from repro_torch.diffusion.unet import UNetConfig

ACT_BYTES = 1.5        # INT12
WEIGHT_BYTES = 1.0     # INT8
SAS_BYTES = 1.5        # scores stored INT12


@dataclasses.dataclass(frozen=True)
class LedgerOptions:
    """What the datapath does this iteration."""
    pssa: bool = False
    tips: bool = False
    # measured (compressed bytes / dense bytes) for the SAS, per feature-map
    # resolution; 1.0 = no compression.  Keys are resolutions (64/32/16).
    sas_ratio: Optional[dict] = None
    # measured fraction of tokens at INT6 in the FFN this iteration
    tips_low_ratio: float = 0.0
    # whether the TIPS mask covers the second FFN matmul too (the paper's
    # "INT12 through the whole FFN stack" reading, and this ledger's
    # historical accounting).  The functional datapath exposes the same
    # switch as PrecisionPolicy.ffn_mid; energy_report passes it through so
    # the MAC precision split matches what the datapath actually does.
    tips_mid: bool = True
    batch: int = 1

    def sas_factor(self, res: int) -> float:
        if not self.pssa:
            return 1.0
        if self.sas_ratio and res in self.sas_ratio:
            return float(self.sas_ratio[res])
        # paper Fig. 5(a): PSSA cuts SAS EMA by 61.2 % vs no compression
        return 1.0 - 0.612


def _resnet_traffic(tag, res, cin, cout, tdim, batch) -> LayerTraffic:
    t = res * res * batch
    macs = t * 9 * cin * cout + t * 9 * cout * cout + batch * tdim * cout
    w = 9 * cin * cout + 9 * cout * cout + tdim * cout
    if cin != cout:
        w += cin * cout
        macs += t * cin * cout
    return LayerTraffic(
        name=tag, stage="cnn",
        weight_bytes=w * WEIGHT_BYTES,
        act_in_bytes=t * cin * ACT_BYTES,
        act_out_bytes=t * cout * ACT_BYTES,
        macs_high=macs,
    )


def _transformer_traffic(tag, res, c, cfg: UNetConfig,
                         opts: LedgerOptions) -> list:
    """One transformer block -> [self_attn, cross_attn, ffn] entries."""
    b = opts.batch
    t = res * res * b
    heads = cfg.num_heads
    tt = cfg.text_len * b
    dff = cfg.ffn_mult * c
    out = []

    # --- self-attention ---
    sas_dense = heads * (res * res) ** 2 * b * SAS_BYTES * 2.0   # write+read
    sas = sas_dense * opts.sas_factor(res)
    qkvo_w = 4 * c * c
    sa_macs = t * 4 * c * c + 2.0 * heads * (res * res) ** 2 * b * (c // heads)
    out.append(LayerTraffic(
        name=tag + ".self_attn", stage="self_attn",
        weight_bytes=qkvo_w * WEIGHT_BYTES,
        act_in_bytes=t * c * ACT_BYTES,
        act_out_bytes=t * 4 * c * ACT_BYTES,   # q,k,v spill + attn out
        sas_bytes=sas,
        macs_high=sa_macs,
    ))

    # --- cross-attention (scores are T x 77 — small; still DRAM traffic) ---
    cas = heads * (res * res) * cfg.text_len * b * SAS_BYTES * 2.0
    ca_macs = (t * 2 * c * c + tt * 2 * cfg.context_dim * c
               + 2.0 * heads * (res * res) * cfg.text_len * b * (c // heads))
    out.append(LayerTraffic(
        name=tag + ".cross_attn", stage="cross_attn",
        weight_bytes=(2 * c * c + 2 * cfg.context_dim * c) * WEIGHT_BYTES,
        act_in_bytes=(t * c + tt * cfg.context_dim) * ACT_BYTES,
        act_out_bytes=(t * 2 * c + tt * 2 * c) * ACT_BYTES,
        sas_bytes=cas,
        macs_high=ca_macs,
    ))

    # --- FFN (GEGLU) with TIPS mixed precision ---
    # The GEGLU runs as one fused layer (mid activations stay on-chip, so
    # there is no mid byte term); the MAC precision split is per matmul:
    # the up projection always follows the TIPS row mask, the down
    # projection (ff_out) only when the datapath's mask coverage extends
    # to it (``tips_mid`` <-> PrecisionPolicy.ffn_mid).
    macs_up = t * 2 * dff * c                     # geglu up (2f)
    macs_down = t * dff * c                       # down (ff_out)
    low = opts.tips_low_ratio if opts.tips else 0.0
    low_down = low if opts.tips_mid else 0.0
    ffn_w = 2 * dff * c + dff * c
    # TIPS also halves the *activation* bytes of INT6 rows (12 -> 6 bits)
    act_in = t * c * (1.0 - 0.5 * low) * ACT_BYTES
    out.append(LayerTraffic(
        name=tag + ".ffn", stage="ffn",
        weight_bytes=ffn_w * WEIGHT_BYTES,
        act_in_bytes=act_in,
        act_out_bytes=t * c * ACT_BYTES,
        macs_high=macs_up * (1.0 - low) + macs_down * (1.0 - low_down),
        macs_low=macs_up * low + macs_down * low_down,
    ))
    return out


def unet_ledger(cfg: UNetConfig,
                opts: LedgerOptions = LedgerOptions()) -> list:
    """All LayerTraffic entries of ONE UNet iteration (full geometry)."""
    entries = []
    chans = cfg.block_channels
    res = cfg.latent_size
    b = opts.batch

    entries.append(LayerTraffic(
        name="conv_in", stage="cnn",
        weight_bytes=9 * cfg.in_channels * chans[0] * WEIGHT_BYTES,
        act_in_bytes=res * res * cfg.in_channels * b * ACT_BYTES,
        act_out_bytes=res * res * chans[0] * b * ACT_BYTES,
        macs_high=res * res * b * 9 * cfg.in_channels * chans[0]))

    # --- down path ---
    skip_channels = [chans[0]]
    cin = chans[0]
    for i, cout in enumerate(chans):
        for r in range(cfg.resnets_per_down):
            entries.append(_resnet_traffic(f"down{i}.res{r}", res, cin, cout,
                                           cfg.time_dim, b))
            if cfg.down_attn[i]:
                entries.extend(_transformer_traffic(
                    f"down{i}.attn{r}", res, cout, cfg, opts))
            cin = cout
            skip_channels.append(cout)
        if i < len(chans) - 1:
            entries.append(LayerTraffic(
                name=f"down{i}.downsample", stage="cnn",
                weight_bytes=9 * cout * cout * WEIGHT_BYTES,
                act_in_bytes=res * res * cout * b * ACT_BYTES,
                act_out_bytes=(res // 2) ** 2 * cout * b * ACT_BYTES,
                macs_high=(res // 2) ** 2 * b * 9 * cout * cout))
            skip_channels.append(cout)
            res //= 2

    # --- up path ---
    rev = list(reversed(range(len(chans))))
    cin = chans[-1]
    for j, i in enumerate(rev):
        cout = chans[i]
        for r in range(cfg.resnets_per_up):
            skip_c = skip_channels.pop()
            entries.append(_resnet_traffic(f"up{j}.res{r}", res,
                                           cin + skip_c, cout,
                                           cfg.time_dim, b))
            if cfg.down_attn[i]:
                entries.extend(_transformer_traffic(
                    f"up{j}.attn{r}", res, cout, cfg, opts))
            cin = cout
        if j < len(chans) - 1:
            entries.append(LayerTraffic(
                name=f"up{j}.upsample", stage="cnn",
                weight_bytes=9 * cout * cout * WEIGHT_BYTES,
                act_in_bytes=res * res * cout * b * ACT_BYTES,
                act_out_bytes=(res * 2) ** 2 * cout * b * ACT_BYTES,
                macs_high=(res * 2) ** 2 * b * 9 * cout * cout))
            res *= 2

    entries.append(LayerTraffic(
        name="conv_out", stage="cnn",
        weight_bytes=9 * chans[0] * cfg.out_channels * WEIGHT_BYTES,
        act_in_bytes=res * res * chans[0] * b * ACT_BYTES,
        act_out_bytes=res * res * cfg.out_channels * b * ACT_BYTES,
        macs_high=res * res * b * 9 * chans[0] * cfg.out_channels))
    return entries


def dit_ledger(cfg, opts: LedgerOptions = LedgerOptions()) -> list:
    """Every LayerTraffic entry of ONE DiT iteration (full geometry).

    ``cfg`` is a ``repro_torch.diffusion.dit.DiTConfig``.  The patch
    embedding and the final projection are the only stages outside the
    blocks; each block is ``_transformer_traffic`` at the one token
    resolution, so the SAS / CAS / FFN accounting and the points where the
    measured ratios enter are the UNet's.
    """
    b = opts.batch
    g = cfg.latent_size // cfg.patch
    d = cfg.hidden_size
    t = g * g * b
    pe = cfg.patch * cfg.patch * cfg.in_channels
    po = cfg.patch * cfg.patch * cfg.out_channels
    entries = [LayerTraffic(
        name="patch_embed", stage="cnn",
        weight_bytes=pe * d * WEIGHT_BYTES,
        act_in_bytes=cfg.latent_size ** 2 * cfg.in_channels * b * ACT_BYTES,
        act_out_bytes=t * d * ACT_BYTES,
        macs_high=t * pe * d)]
    for i in range(cfg.depth):
        entries.extend(_transformer_traffic(f"block{i}", g, d, cfg, opts))
    entries.append(LayerTraffic(
        name="final_layer", stage="cnn",
        weight_bytes=d * po * WEIGHT_BYTES,
        act_in_bytes=t * d * ACT_BYTES,
        act_out_bytes=cfg.latent_size ** 2 * cfg.out_channels * b * ACT_BYTES,
        macs_high=t * d * po))
    return entries


def denoiser_ledger(cfg, opts: LedgerOptions = LedgerOptions()) -> list:
    """The family's per-iteration ledger, the family resolved through the
    denoiser registry (``denoiser.family_of``)."""
    return _FAMILY_LEDGERS[family_of(cfg)](cfg, opts)


_FAMILY_LEDGERS = {"unet": unet_ledger, "dit": dit_ledger}


def iteration_report(cfg,
                     opts: LedgerOptions = LedgerOptions()) -> EnergyReport:
    return report(denoiser_ledger(cfg, opts))


def generation_report(cfg, per_iter_opts: Iterable[LedgerOptions]
                      ) -> EnergyReport:
    """Whole text-to-image run: one denoiser ledger per iteration."""
    entries = []
    for opts in per_iter_opts:
        entries.extend(denoiser_ledger(cfg, opts))
    return report(entries)
