"""Denoiser contract: the model-agnostic interface the runtime serves (port
of ``repro.diffusion.denoiser``).

The engine, sampler, slots, solver banks, temporal reuse and the ledger
consume only what a forward pass returns: an eps prediction shaped like
the latents, a stats object whose layer order comes from the config
(``cfg.layer_order()``), and, under temporal reuse, a new per-layer cache
in that same order.  ``Denoiser`` pairs a family with its frozen config;
the registry maps each config class to its family, so
``make_denoiser(cfg)`` resolves the family from the config alone.
``repro_torch.diffusion.unet`` and ``repro_torch.diffusion.dit`` register
themselves on import; the lookup imports them lazily, so this module
imports neither.

``init_params(generator, device)``
    Fresh parameters for ``cfg``, drawn from a ``torch.Generator`` on
    ``device``; ``None`` means the card (``runtime.resolve_device``), so
    the CPU takes ``device="cpu"``.

``apply(params, latents, timesteps, context, **kw)``
    The forward pass: ``latents`` (B, S, S, C), ``timesteps`` (B,),
    ``context`` (B or 2B, T_text, ctx_dim), with the UNet's keywords
    (``tips_active``, ``stats_rows``, ``cfg_dup``, ``row_stats``,
    ``reuse_cache``, ``overrides``).  Returns ``(eps, stats)`` or, with a
    reuse cache under an enabled policy, ``(eps, stats, new_cache)``.

``layer_order()``
    The ``stats.LayerKey`` tuple of the config.

``abstract_params()``
    The parameter tree's shapes and dtypes on the meta device: nothing is
    allocated.

The config hooks the runtime calls on any registered config:
``layer_order()``, ``channels_at(res)`` (token width at a resolution),
``full_geometry()`` (the full-size config the analytic ledger targets)
and ``attn_resolutions()`` (distinct attention resolutions, descending).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple


class FamilySpec(NamedTuple):
    """One registered denoiser family, looked up by its config class."""
    family: str
    config_cls: type
    init_params: Callable       # (cfg, generator, device) -> params
    forward: Callable           # (params, lat, t, ctx, cfg, **kw) -> tuple
    abstract_params: Callable   # (cfg) -> params on the meta device


_REGISTRY: dict = {}            # family name -> FamilySpec
_BY_CONFIG: dict = {}           # config class -> FamilySpec

FAMILIES = ("unet", "dit")


def register_family(spec: FamilySpec) -> None:
    """Called at import time by each family module (unet.py, dit.py)."""
    _REGISTRY[spec.family] = spec
    _BY_CONFIG[spec.config_cls] = spec


def _ensure_registered() -> None:
    # imported here, not at the top, so that stats / engine / sampler can
    # import this module without a cycle
    import repro_torch.diffusion.dit    # noqa: F401  (registers "dit")
    import repro_torch.diffusion.unet   # noqa: F401  (registers "unet")


def family_of(cfg) -> str:
    """The family name a denoiser config belongs to."""
    _ensure_registered()
    spec = _BY_CONFIG.get(type(cfg))
    if spec is None:
        known = sorted(c.__name__ for c in _BY_CONFIG)
        raise TypeError(f"no denoiser family registered for "
                        f"{type(cfg).__name__}; known configs: {known}")
    return spec.family


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """Frozen, hashable handle pairing a family with its config.

    ``engine.DiffusionEngine`` and ``pipeline.StableDiffusionPipeline``
    hold one instead of calling a family's forward directly.
    """
    family: str
    cfg: object                  # a frozen config dataclass

    def _spec(self) -> FamilySpec:
        _ensure_registered()
        return _REGISTRY[self.family]

    def init_params(self, generator=None, device=None):
        """Fresh parameters on ``device`` (``None``: the card)."""
        return self._spec().init_params(self.cfg, generator, device)

    def apply(self, params, latents, timesteps, context, **kw):
        return self._spec().forward(params, latents, timesteps, context,
                                    self.cfg, **kw)

    def layer_order(self):
        from repro_torch.diffusion.stats import attn_layer_order
        return attn_layer_order(self.cfg)

    def abstract_params(self):
        return self._spec().abstract_params(self.cfg)


def make_denoiser(cfg) -> Denoiser:
    """Resolve a config to its registered family's ``Denoiser``."""
    return Denoiser(family=family_of(cfg), cfg=cfg)
