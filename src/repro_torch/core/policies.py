"""ServePolicies: the serving-policy bundle (port of
``repro.core.policies``; DESIGN.md §13).

Kernel routing (``kernels.dispatch.KernelPolicy``), TIPS/DBSC precision
(``core.precision.PrecisionPolicy``), temporal patch reuse
(``core.reuse.ReusePolicy``) and sampling (``diffusion.solvers
.SamplerPolicy`` and a bank) in one frozen, hashable object:

* ``parse()`` builds it from the CLI flag specs (``--kernels``,
  ``--tips``, ``--reuse``, ``--solver``, ``--tiers``); ``launch.cli``
  feeds every CLI through it;
* ``apply()`` installs the kernel, precision and reuse axes on a
  pipeline config, and ``DiffusionEngine(policies=)`` takes the sampling
  axes as the defaults of ``generate`` and ``init_slots``;
* ``describe()`` is the JSON view serving metrics embed.

The port's configs carry no legacy fold-in knobs (no ``use_dbsc_kernel``
or ``tips_threshold``), so ``from_config`` reads ``kernel_policy``,
``precision`` and ``reuse_policy`` as they are, and the JAX package's
legacy-alias warnings have nothing to warn about here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.reuse import ReusePolicy
from repro_torch.diffusion import solvers
from repro_torch.diffusion.solvers import SamplerPolicy
from repro_torch.kernels.dispatch import KernelPolicy


@dataclasses.dataclass(frozen=True)
class ServePolicies:
    """Frozen bundle of every serving-policy axis.

    ``sampler`` is the per-request solver and step budget, ``bank`` the
    tuple of distinct policies a mixed-tier slot batch may carry
    (``sampler`` must be an entry of ``bank`` when both are set).  ``None``
    on either keeps the config's DDIM schedule.
    """
    kernels: KernelPolicy = KernelPolicy()
    precision: PrecisionPolicy = PrecisionPolicy()
    reuse: ReusePolicy = ReusePolicy()
    sampler: Optional[SamplerPolicy] = None
    bank: Optional[Tuple[SamplerPolicy, ...]] = None

    def __post_init__(self):
        if self.bank is not None:
            object.__setattr__(self, "bank", solvers.as_bank(self.bank))
            if self.sampler is not None and self.sampler not in self.bank:
                raise ValueError(
                    f"ServePolicies.sampler {self.sampler.key()} is not an "
                    f"entry of the bank {[p.key() for p in self.bank]}")

    @classmethod
    def parse(cls, kernels: str = "auto", tips: str = "fixed",
              reuse: str = "off", solver: str = "", tiers=None,
              device=None) -> "ServePolicies":
        """Build the bundle from the CLI flag specs.

        ``solver`` is one ``SamplerPolicy`` spec for every request,
        ``tiers`` a list of specs forming a mixed-tier bank; the two are
        exclusive.  ``device`` (``None``: the card) resolves ``auto``.
        """
        if solver and tiers:
            raise ValueError(
                "ServePolicies.parse: solver= and tiers= are exclusive "
                "(a bank already names every policy in flight)")
        bank = (solvers.as_bank(tuple(SamplerPolicy.parse(t)
                                      for t in tiers))
                if tiers else None)
        return cls(kernels=KernelPolicy.parse(kernels, device=device),
                   precision=PrecisionPolicy.parse(tips),
                   reuse=ReusePolicy.parse(reuse),
                   sampler=SamplerPolicy.parse(solver) if solver else None,
                   bank=bank)

    @classmethod
    def from_config(cls, unet_cfg, sampler=None, bank=None
                    ) -> "ServePolicies":
        """The policies a denoiser config (UNet or DiT) carries."""
        return cls(kernels=unet_cfg.kernel_policy,
                   precision=unet_cfg.precision,
                   reuse=unet_cfg.reuse_policy,
                   sampler=sampler,
                   bank=solvers.as_bank(bank) if bank is not None else None)

    def apply(self, cfg):
        """``cfg`` (a ``pipeline.PipelineConfig``) with this bundle's
        kernel, precision and reuse policies installed on ``cfg.unet``;
        the sampling axes are runtime arguments, not config fields."""
        return dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet,
                                          kernel_policy=self.kernels,
                                          precision=self.precision,
                                          reuse_policy=self.reuse))

    def with_sampling(self, sampler=None, bank=None) -> "ServePolicies":
        """Copy with the sampling axes replaced, the others kept."""
        return dataclasses.replace(
            self, sampler=sampler,
            bank=solvers.as_bank(bank) if bank is not None else None)

    def key(self) -> tuple:
        """The five axes as one hashable tuple: equal bundles, however
        spelled, give equal keys."""
        return (self.kernels, self.precision, self.reuse,
                self.sampler, self.bank)

    def describe(self, device=None) -> dict:
        """JSON-friendly view for serving metrics; ``device`` (``None``:
        the card) names the kernel policy's backend."""
        return {
            "kernels": self.kernels.describe(device),
            "precision": self.precision.describe(),
            "reuse": self.reuse.describe(),
            "sampler": (None if self.sampler is None
                        else self.sampler.describe()),
            "bank": (None if self.bank is None
                     else [p.describe() for p in self.bank]),
        }
