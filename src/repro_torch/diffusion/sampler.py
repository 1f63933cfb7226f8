"""DDIM sampler, 25 iterations (port of ``repro.diffusion.sampler``).

Deterministic DDIM (eta = 0) over a linear-beta DDPM schedule with
classifier-free guidance; TIPS is active for the first ``tips_active_iters``
iterations.

``sample``       — the seed loop: two UNet calls per step under CFG.
``sample_scan``  — the engine's loop: a Python loop over ``denoise_step``,
                   cond + uncond fused into ONE UNet call per step with the
                   shared prefix run once (``cfg_dup``); returns the stats
                   trajectory stacked along a leading ``num_steps`` axis.
``sample_scan_reuse`` — the same loop with the temporal-reuse cache,
                   carried from step to step (temporal mode) or read from
                   a base request's recorded per-step caches (edit mode).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tips import TIPS_ACTIVE_ITERS
from repro_torch.diffusion.stats import UNetStats


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_steps: int = 1000
    num_inference_steps: int = 25        # paper: 25 UNet iterations
    beta_start: float = 0.00085
    beta_end: float = 0.012
    guidance_scale: float = 7.5
    tips_active_iters: int = TIPS_ACTIVE_ITERS


def alphas_cumprod(cfg: DDIMConfig, device="cpu") -> torch.Tensor:
    """float32 linspace of sqrt(beta), squared, cumulative product.

    Agrees with the JAX package to a few float32 ulps, not bit for bit: XLA
    evaluates ``linspace`` and ``cumprod`` in another order (and the JAX
    package's own jitted and eager values differ the same way).
    """
    betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_steps, dtype=torch.float32,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timestep_schedule(cfg: DDIMConfig, device="cpu") -> torch.Tensor:
    """Descending DDIM timesteps, e.g. [960, 920, ..., 0] for 25 steps."""
    step = cfg.num_train_steps // cfg.num_inference_steps
    return torch.arange(cfg.num_inference_steps - 1, -1, -1,
                        device=device) * step


def ddim_transfer(latents, eps, a_t, a_prev):
    """The deterministic DDIM (eta=0) transfer, coefficients pre-gathered."""
    x0 = (latents - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddim_step(latents, eps, t, t_prev, acp):
    """One DDIM update; ``t`` / ``t_prev`` are scalars or (B,) per row."""
    t = torch.as_tensor(t, device=acp.device)
    t_prev = torch.as_tensor(t_prev, device=acp.device)
    a_t = acp[t]
    a_prev = torch.where(t_prev >= 0, acp[torch.clamp_min(t_prev, 0)],
                         torch.ones((), device=acp.device))
    if a_t.ndim == 1:
        shape = (latents.shape[0],) + (1,) * (latents.ndim - 1)
        a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
    return ddim_transfer(latents, eps, a_t, a_prev)


def cfg_batch(latents, context, uncond_context):
    """Fuse cond + uncond into one [cond | uncond] batch."""
    return (torch.cat([latents, latents], dim=0),
            torch.cat([context, uncond_context], dim=0))


def guided_eps(eps_fused, guidance_scale):
    """Split a fused [cond | uncond] eps and apply CFG."""
    eps_c, eps_u = torch.chunk(eps_fused, 2, dim=0)
    return eps_u + guidance_scale * (eps_c - eps_u)


def sample(unet_apply, latents, context, uncond_context, cfg: DDIMConfig,
           collect_stats: bool = False):
    """The seed loop: ``unet_apply(latents, t, context, tips_active)`` ->
    (eps, stats), called twice per step under CFG."""
    acp = alphas_cumprod(cfg, latents.device)
    ts = timestep_schedule(cfg).tolist()
    step = cfg.num_train_steps // cfg.num_inference_steps
    all_stats = []
    for i in range(cfg.num_inference_steps):
        t = ts[i]
        tips_active = i < cfg.tips_active_iters
        tvec = torch.full((latents.shape[0],), t, dtype=torch.int32,
                          device=latents.device)
        eps_c, stats = unet_apply(latents, tvec, context, tips_active)
        if cfg.guidance_scale != 1.0 and uncond_context is not None:
            eps_u, _ = unet_apply(latents, tvec, uncond_context, tips_active)
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
        else:
            eps = eps_c
        latents = ddim_step(latents, eps, t, t - step, acp)
        if collect_stats:
            all_stats.append(stats)
    return latents, all_stats


def denoise_step(unet_apply, latents, context, uncond_context, step_idx: int,
                 cfg: DDIMConfig, stats_rows=None, reuse_cache=None):
    """ONE denoising update with every row at iteration ``step_idx``.

    Under CFG the cond and uncond UNet evaluations are one batched call with
    the shared prefix deduplicated (``cfg_dup``), and the PSSA/TIPS stats
    cover the cond rows only (``stats_rows`` defaults to the batch).

    ``reuse_cache`` (a ``core.reuse.ReuseCache``) is passed to the UNet,
    which then returns the new cache, and so does this function:
    ``(latents, stats, new_cache)``.  Without it: ``(latents, stats)``.
    """
    acp = alphas_cumprod(cfg, latents.device)
    ts = timestep_schedule(cfg, latents.device)
    step = cfg.num_train_steps // cfg.num_inference_steps
    b = latents.shape[0]
    idx = torch.full((b,), min(max(step_idx, 0), cfg.num_inference_steps - 1),
                     dtype=torch.int64, device=latents.device)
    t = ts[idx]                                   # (B,) per-row timesteps
    tips_vec = idx < cfg.tips_active_iters        # (B,) per-row TIPS flag
    kw = {} if reuse_cache is None else {"reuse_cache": reuse_cache}
    use_cfg = cfg.guidance_scale != 1.0 and uncond_context is not None
    if use_cfg:
        ctx_fused = torch.cat([context, uncond_context], dim=0)
        rows = b if stats_rows is None else stats_rows
        out = unet_apply(latents, t, ctx_fused, tips_vec, stats_rows=rows,
                         cfg_dup=True, **kw)
    else:
        out = unet_apply(latents, t, context, tips_vec,
                         stats_rows=stats_rows, **kw)
    eps, stats = out[:2]
    if use_cfg:
        eps = guided_eps(eps, cfg.guidance_scale)
    latents = ddim_step(latents, eps, t, t - step, acp)
    if reuse_cache is not None:
        return latents, stats, out[2]
    return latents, stats


def sample_scan(unet_apply, latents, context, uncond_context,
                cfg: DDIMConfig, stats_rows=None):
    """All denoising steps as a loop over :func:`denoise_step`.

    Returns ``(latents, stacked UNetStats)`` (leading axis = iterations).
    """
    b = latents.shape[0]
    if stats_rows is not None and not (0 < stats_rows <= b):
        raise ValueError(f"stats_rows={stats_rows} outside [1, {b}]")
    per_step = []
    for i in range(cfg.num_inference_steps):
        latents, stats = denoise_step(unet_apply, latents, context,
                                      uncond_context, i, cfg,
                                      stats_rows=stats_rows)
        per_step.append(stats)
    return latents, UNetStats.stack(per_step)


def sample_scan_reuse(unet_apply, latents, context, uncond_context,
                      cfg: DDIMConfig, reuse_cache=None, stats_rows=None,
                      base_caches=None, record_caches: bool = False):
    """All denoising steps with the temporal-reuse cache threaded.

    * **temporal** — ``reuse_cache`` (typically the all-invalid
      ``core.reuse.reuse_cache_zeros``) is carried: each step reuses the
      PREVIOUS step's activations.  ``record_caches=True`` also keeps
      every step's new cache, in a list indexed by step (the base trace
      of an edit), and returns ``(latents, stats, caches)``.
    * **edit** — ``base_caches`` is such a list from a BASE request: step
      ``i`` reuses the base's step-``i`` activations, which are valid
      from step 0, so ``capacity < 1`` is safe.

    Returns ``(latents, stacked UNetStats)`` with per-layer reuse
    counters (plus the recorded caches when asked).
    """
    b = latents.shape[0]
    if stats_rows is not None and not (0 < stats_rows <= b):
        raise ValueError(f"stats_rows={stats_rows} outside [1, {b}]")
    if (reuse_cache is None) == (base_caches is None):
        raise ValueError(
            "pass exactly one of reuse_cache (temporal mode) or "
            "base_caches (edit mode)")
    n = cfg.num_inference_steps
    if base_caches is not None and len(base_caches) != n:
        raise ValueError(f"base_caches holds {len(base_caches)} steps, the "
                         f"schedule {n}")
    per_step, caches = [], []
    cache = reuse_cache
    for i in range(n):
        if base_caches is not None:
            cache = base_caches[i]
        latents, stats, cache = denoise_step(
            unet_apply, latents, context, uncond_context, i, cfg,
            stats_rows=stats_rows, reuse_cache=cache)
        per_step.append(stats)
        if record_caches:
            caches.append(cache)
    stacked = UNetStats.stack(per_step)
    if record_caches:
        return latents, stacked, caches
    return latents, stacked
