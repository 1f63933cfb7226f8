"""One-shot diffusion engine (port of ``repro.diffusion.engine``, one-shot
``generate`` only).

encode -> the fused-CFG denoising loop (``sampler.sample_scan``, or
``sampler.sample_scan_reuse`` from an all-invalid cache when
``cfg.unet.reuse_policy`` is enabled) -> decode, with the stats trajectory
stacked along a leading ``num_steps`` axis.
PyTorch runs eagerly, so there is no executable cache; the wall time of a
call is taken after ``torch.cuda.synchronize()`` on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.diffusion.pipeline import (PipelineConfig,
                                            _default_generator, init_params)
from repro_torch.core.reuse import reuse_cache_zeros
from repro_torch.diffusion.sampler import sample_scan, sample_scan_reuse
from repro_torch.diffusion.text_encoder import encode_text
from repro_torch.diffusion.unet import unet_forward
from repro_torch.diffusion.vae import decode
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass
class EngineOutput:
    """One engine call: images plus the stacked stats trajectory."""
    images: torch.Tensor         # (B, 8S, 8S, 3) in [-1, 1]
    latents: torch.Tensor        # (B, S, S, 4) final denoised latents
    stats: object                # UNetStats, leaves (num_steps, ...)


def _check_cfg_inputs(guidance_scale: float, uncond_tokens) -> bool:
    """CFG contract: ``uncond_tokens`` iff ``guidance_scale != 1.0``."""
    wants_cfg = guidance_scale != 1.0
    has_uncond = uncond_tokens is not None
    if wants_cfg and not has_uncond:
        raise ValueError(
            f"guidance_scale={guidance_scale} requires classifier-free "
            "guidance but uncond_tokens is None — pass the unconditional "
            "prompt tokens (or set ddim.guidance_scale=1.0)")
    if has_uncond and not wants_cfg:
        raise ValueError(
            "uncond_tokens were passed but ddim.guidance_scale == 1.0 "
            "disables classifier-free guidance — drop uncond_tokens or "
            "set a guidance_scale != 1.0")
    return wants_cfg


class DiffusionEngine:
    """Holds the parameters and runs the whole text-to-image path.

    ``device=None`` means the card (a host without CUDA raises);
    ``params`` (from ``pipeline.init_params`` or ``repro_torch.convert``)
    default to random ones drawn from ``generator``.  Kernel routing and
    precision are set on the config (``configs.bk_sdm.with_kernel_policy``
    / ``with_precision``).
    """

    def __init__(self, cfg: PipelineConfig, device=None, params=None,
                 generator=None):
        reuse = cfg.unet.reuse_policy
        if reuse.enabled and reuse.capacity < 1.0:
            # the engine's run starts from an INVALID cache: every patch is
            # active on step 0, so a gather narrower than the grid would
            # reuse zeros.  capacity < 1 belongs to the edit path
            # (sampler.sample_scan_reuse with recorded base_caches).
            raise ValueError(
                f"reuse_policy.capacity={reuse.capacity} < 1.0 on the "
                f"engine's temporal path — the cache starts invalid, so "
                f"capacity must be 1.0 (use the edit-mode sampler with "
                f"recorded base caches for shrunken gathers)")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, generator or _default_generator(
                self.device), self.device)
        self.text_params = params["text"]
        self.unet_params = params["unet"]
        self.vae_params = params["vae"]
        self.last_wall_s: Optional[float] = None

    def _unet_apply(self, lat, tvec, ctx, active, **kw):
        return unet_forward(self.unet_params, lat, tvec, ctx, self.cfg.unet,
                            tips_active=active, **kw)

    def init_latents(self, batch: int, generator=None) -> torch.Tensor:
        s = self.cfg.unet.latent_size
        return torch.randn((batch, s, s, self.cfg.unet.in_channels),
                           generator=generator, device=self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, generator=None, uncond_tokens=None,
                 latents=None, stats_rows=None) -> EngineOutput:
        """(B, text_len) tokens -> EngineOutput.

        ``latents`` (drawn from ``generator`` unless given) start the loop;
        ``stats_rows`` restricts the PSSA/TIPS accounting to the first N
        rows.  Wall seconds of the call land in ``self.last_wall_s``.
        """
        cfg = self.cfg
        use_cfg = _check_cfg_inputs(cfg.ddim.guidance_scale, uncond_tokens)
        prompt_tokens = torch.as_tensor(prompt_tokens, device=self.device)
        if latents is None:
            latents = self.init_latents(prompt_tokens.shape[0], generator)
        latents = torch.as_tensor(latents, dtype=torch.float32,
                                  device=self.device)
        t0 = time.perf_counter()
        context = encode_text(self.text_params, prompt_tokens, cfg.text)
        uncond = None
        if use_cfg:
            uncond = encode_text(self.text_params, torch.as_tensor(
                uncond_tokens, device=self.device), cfg.text)
        if cfg.unet.reuse_policy.enabled:
            cache = reuse_cache_zeros(cfg.unet, latents.shape[0],
                                      use_cfg=use_cfg, device=self.device)
            latents, stats = sample_scan_reuse(
                self._unet_apply, latents, context, uncond, cfg.ddim,
                reuse_cache=cache, stats_rows=stats_rows)
        else:
            latents, stats = sample_scan(self._unet_apply, latents, context,
                                         uncond, cfg.ddim,
                                         stats_rows=stats_rows)
        images = decode(self.vae_params, latents, cfg.vae)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_wall_s = time.perf_counter() - t0
        return EngineOutput(images=images, latents=latents, stats=stats)
