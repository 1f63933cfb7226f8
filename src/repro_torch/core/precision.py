"""PrecisionPolicy — TIPS/DBSC precision decisions (port of
``repro.core.precision``).

``fixed`` spotting marks a pixel important when its head-averaged CAS is
below a threshold; ``adaptive`` thresholds each sample's CAS at the
quantile that puts ``target_low_ratio`` of its tokens at INT6.  Both decide
per sample.  ``ffn_mid`` extends the mask to the second FFN matmul.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tips

_SPOTTING = ("fixed", "adaptive")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    spotting: str = "fixed"
    threshold: float = 0.05          # fixed mode: important <=> CAS < this
    target_low_ratio: float = 0.448  # adaptive mode: INT6 fraction to realize
    ffn_mid: bool = False            # TIPS mask also covers ff_out (INT6 mid)
    cls_index: int = 0               # CLS position in the text keys

    def __post_init__(self):
        if self.spotting not in _SPOTTING:
            raise ValueError(
                f"PrecisionPolicy.spotting={self.spotting!r}: expected one "
                f"of {_SPOTTING}")
        if not 0.0 <= self.target_low_ratio <= 1.0:
            raise ValueError(
                f"PrecisionPolicy.target_low_ratio={self.target_low_ratio}: "
                f"expected a fraction in [0, 1]")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError(
                f"PrecisionPolicy.threshold={self.threshold}: CAS is a "
                f"softmax probability — expected a cut in (0, 1]")
        if self.cls_index < 0:
            raise ValueError(
                f"PrecisionPolicy.cls_index={self.cls_index}: must be >= 0")

    @classmethod
    def fixed(cls, threshold: float = 0.05) -> "PrecisionPolicy":
        return cls(spotting="fixed", threshold=threshold)

    @classmethod
    def adaptive(cls, target_low_ratio: float = 0.448) -> "PrecisionPolicy":
        return cls(spotting="adaptive", target_low_ratio=target_low_ratio)


def spot_cas(cas: torch.Tensor, policy: PrecisionPolicy,
             threshold_scale=None) -> tips.TIPSResult:
    """Importance spotting from head-averaged CAS (..., Tq) per the policy.

    ``torch.quantile`` and ``jnp.quantile`` both interpolate linearly.
    ``threshold_scale`` (a (B,) float32, phase-scheduled sampling) scales
    each row's threshold, fixed or adaptive; None leaves both modes as
    they were, op for op.
    """
    if policy.spotting == "adaptive":
        thr = torch.quantile(cas, 1.0 - policy.target_low_ratio, dim=-1,
                             keepdim=True)
    else:
        thr = policy.threshold
    if threshold_scale is not None:
        scale = threshold_scale.reshape(
            threshold_scale.shape + (1,) * (cas.ndim - threshold_scale.ndim))
        thr = thr * scale
    important = cas < thr
    low_ratio = 1.0 - important.to(torch.float32).mean()
    return tips.TIPSResult(important=important, cas=cas,
                           low_precision_ratio=low_ratio)
