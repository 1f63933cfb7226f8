"""Analytic energy model (28 nm) for the SD-processor reproduction
(copy of ``repro.core.energy``).

The paper evaluates *energy, throughput, and memory access* — not accuracy.
We therefore keep a bytes-accurate external-memory-access (EMA) ledger plus a
per-MAC energy table, calibrated so the **baseline** configuration lands on
the paper's published operating points:

  * 1.9 GB EMA per UNet iteration (INT12 act / INT8 weight, no compression)
  * 213.3 mJ/iter with EMA      (optimized datapath, compressed EMA)
  * 28.6 mJ/iter without EMA    (optimized datapath)
  * 225.6 mW average power, 3.84 TOPS peak, 250 MHz, 1 V

Derivation of the DRAM constant: the optimized run moves
1.9 GB x (1 - 0.378) = 1.18 GB and the EMA adder is 213.3 - 28.6 = 184.7 mJ,
giving 156 pJ/byte (= 19.6 pJ/bit — squarely in LPDDR4 territory).

MAC energies: the DBSC computes INT12xINT8 as two INT7xINT8 bit-slice
products.  The paper's +43.0 % FFN efficiency with 44.8 % of rows at INT6
pins the INT6:INT12 energy ratio at ~0.33 (0.552 + 0.448*c = 1/1.43).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

# ----------------------------------------------------------------------------
# Calibrated constants (28 nm, 1 V, 250 MHz)
# ----------------------------------------------------------------------------
DRAM_PJ_PER_BYTE = 156.0        # LPDDR-class external memory
SRAM_PJ_PER_BYTE = 1.25         # global buffer (192 KB) access
MAC_PJ = {
    "int12x8": 0.1143,          # full two-slice DBSC MAC (calibrated, see below)
    "int7x8": 0.0572,           # one bit-slice PE MAC
    "int6x8": 0.0377,           # low-precision path: one slice + narrow adders
    "int8x8": 0.0650,
    "bf16": 0.3800,             # reference only (not used by the ASIC path)
}
# Calibration note: with the BK-SDM-Tiny workload ledger
# (`repro_torch.diffusion.ledger`) the INT12 MAC count is ~229 GMAC/iter; at
# 0.1143 pJ/MAC + SRAM traffic the compute-side energy lands on 28.6 mJ/iter
# after TIPS+DBSC, matching Table I.  See benchmarks/bench_energy_iter.py.

PEAK_TOPS = 3.84
AVG_POWER_MW = 225.6
FREQ_MHZ = 250.0


@dataclasses.dataclass(frozen=True)
class LayerTraffic:
    """EMA + compute footprint of one layer invocation."""
    name: str
    stage: str                  # 'cnn' | 'self_attn' | 'cross_attn' | 'ffn' | 'other'
    weight_bytes: float = 0.0
    act_in_bytes: float = 0.0
    act_out_bytes: float = 0.0
    sas_bytes: float = 0.0      # self-attention score write+read traffic
    macs_high: float = 0.0      # INT12-activation MACs
    macs_low: float = 0.0       # INT6-activation MACs (TIPS rows)

    @property
    def ema_bytes(self) -> float:
        return (self.weight_bytes + self.act_in_bytes
                + self.act_out_bytes + self.sas_bytes)


@dataclasses.dataclass
class EnergyReport:
    ema_bytes_total: float
    ema_bytes_by_stage: dict
    sas_bytes: float
    ema_energy_mj: float
    compute_energy_mj: float

    @property
    def total_mj(self) -> float:
        return self.ema_energy_mj + self.compute_energy_mj

    @property
    def sas_fraction(self) -> float:
        return self.sas_bytes / max(self.ema_bytes_total, 1e-12)

    def stage_fraction(self, *stages: str) -> float:
        tot = max(self.ema_bytes_total, 1e-12)
        return sum(self.ema_bytes_by_stage.get(s, 0.0) for s in stages) / tot


def report(layers: Iterable[LayerTraffic],
           dram_pj_per_byte: float = DRAM_PJ_PER_BYTE,
           mac_pj: dict = MAC_PJ) -> EnergyReport:
    by_stage: dict[str, float] = {}
    total = 0.0
    sas = 0.0
    macs_hi = 0.0
    macs_lo = 0.0
    for l in layers:
        by_stage[l.stage] = by_stage.get(l.stage, 0.0) + l.ema_bytes
        total += l.ema_bytes
        sas += l.sas_bytes
        macs_hi += l.macs_high
        macs_lo += l.macs_low
    ema_mj = total * dram_pj_per_byte * 1e-9
    compute_mj = (macs_hi * mac_pj["int12x8"]
                  + macs_lo * mac_pj["int6x8"]) * 1e-9
    return EnergyReport(
        ema_bytes_total=total,
        ema_bytes_by_stage=by_stage,
        sas_bytes=sas,
        ema_energy_mj=ema_mj,
        compute_energy_mj=compute_mj,
    )


def ffn_energy_gain(low_ratio: float, mac_pj: dict = MAC_PJ) -> float:
    """Paper Fig. 9(c): FFN energy-efficiency gain of DBSC mixed precision.

    Baseline: every row INT12.  DBSC: ``low_ratio`` of rows INT6.
    Returns the multiplicative efficiency gain (0.43 == +43 %).
    """
    base = mac_pj["int12x8"]
    mixed = (1.0 - low_ratio) * mac_pj["int12x8"] + low_ratio * mac_pj["int6x8"]
    return base / mixed - 1.0


def iter_time_s(total_macs: float, utilization: float = 0.5,
                peak_tops: float = PEAK_TOPS) -> float:
    """Wall time of one UNet iteration on the 3.84 TOPS array."""
    ops = 2.0 * total_macs
    return ops / (peak_tops * 1e12 * utilization)
