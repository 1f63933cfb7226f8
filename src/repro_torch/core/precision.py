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

    @classmethod
    def parse(cls, spec: str) -> "PrecisionPolicy":
        """Build a policy from a CLI spec (the ``--tips`` flag).

        A comma-separated list where a bare ``fixed`` / ``adaptive``
        selects the spotting mode and ``key=value`` items override fields,
        e.g. ``"adaptive,target=0.5,mid=true"`` or ``"threshold=0.02"``.
        Keys: ``threshold``, ``target`` (target_low_ratio), ``mid``
        (ffn_mid), ``cls`` (cls_index), ``spotting``.
        """
        fields = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if item in _SPOTTING:
                fields["spotting"] = item
                continue
            if "=" not in item:
                raise ValueError(
                    f"tips policy spec {item!r}: expected a spotting mode "
                    f"in {_SPOTTING} or key=value")
            key, val = (s.strip() for s in item.split("=", 1))
            if key == "threshold":
                fields["threshold"] = float(val)
            elif key == "target":
                fields["target_low_ratio"] = float(val)
            elif key == "mid":
                if val.lower() not in ("true", "false"):
                    raise ValueError(
                        f"tips policy spec: mid={val!r} (expected true or "
                        f"false)")
                fields["ffn_mid"] = val.lower() == "true"
            elif key == "cls":
                fields["cls_index"] = int(val)
            elif key == "spotting":
                fields["spotting"] = val
            else:
                raise ValueError(
                    f"tips policy spec: unknown key {key!r} (expected "
                    f"threshold, target, mid, cls or spotting)")
        return cls(**fields)

    def describe(self) -> dict:
        """JSON-friendly view for serving metrics and records."""
        return {
            "spotting": self.spotting,
            "threshold": self.threshold,
            "target_low_ratio": self.target_low_ratio,
            "ffn_mid": self.ffn_mid,
            "cls_index": self.cls_index,
        }


def spot_cas(cas: torch.Tensor, policy: PrecisionPolicy,
             threshold_scale=None) -> tips.TIPSResult:
    """Importance spotting from head-averaged CAS (..., Tq) per the policy.

    The adaptive quantile is ``tips.adaptive_threshold`` along the token
    axis, bit for bit ``jnp.quantile``'s.  ``threshold_scale`` (a (B,)
    float32, phase-scheduled sampling) scales each row's threshold, fixed
    or adaptive; None leaves both modes as they were, op for op.
    """
    if policy.spotting == "adaptive":
        thr = tips.adaptive_threshold(cas, policy.target_low_ratio, dim=-1)
    else:
        thr = policy.threshold
    if threshold_scale is not None:
        scale = threshold_scale.reshape(
            threshold_scale.shape + (1,) * (cas.ndim - threshold_scale.ndim))
        thr = thr * scale
    important = cas < thr
    return tips.TIPSResult(
        important=important, cas=cas,
        low_precision_ratio=tips.mask_low_precision_ratio(important))
