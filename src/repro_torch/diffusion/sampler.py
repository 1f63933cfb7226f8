"""DDIM sampler, 25 iterations (port of ``repro.diffusion.sampler``).

Deterministic DDIM (eta = 0) over a linear-beta DDPM schedule with
classifier-free guidance; TIPS is active for the first ``tips_active_iters``
iterations.

``sample``       — the seed loop: two UNet calls per step under CFG.
``sample_scan``  — the engine's loop: a Python loop over ``denoise_step``,
                   cond + uncond fused into ONE UNet call per step with the
                   shared prefix run once (``cfg_dup``); returns the stats
                   trajectory stacked along a leading ``num_steps`` axis.
                   A ``SamplerPolicy`` (and bank) swaps in the per-row
                   solvers of ``diffusion.solvers``.
``denoise_step`` — one step at per-row step indices: the loop body, and
                   the slot runtime's step (``DiffusionEngine.slot_step``).
``sample_scan_reuse`` — the same loop with the temporal-reuse cache,
                   carried from step to step (temporal mode) or read from
                   a base request's recorded per-step caches (edit mode);
                   a ``SamplerPolicy`` (and bank) composes with both.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tips import TIPS_ACTIVE_ITERS
from repro_torch.diffusion import solvers as solvers_mod
from repro_torch.diffusion.stats import UNetStats
from repro_torch.launch import mesh as mesh_mod


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


def denoise_step(unet_apply, latents, context, uncond_context, step_idx,
                 cfg: DDIMConfig, stats_rows=None, reuse_cache=None,
                 active=None, row_stats: bool = False, bank=None,
                 policy_id=None, solver_hist=None):
    """ONE denoising update at PER-ROW step indices.

    ``step_idx`` is a (B,) integer tensor (an int is broadcast): each
    row's iteration.  The alphas and the TIPS activity flag are gathered
    per row, so a slot runtime can run rows at different steps in one
    batched UNet call; with every row at one index the arithmetic is the
    one-shot loop's, op for op.

    Under CFG the cond and uncond UNet evaluations are one batched call with
    the shared prefix deduplicated (``cfg_dup``), and the PSSA/TIPS stats
    cover the cond rows only (``stats_rows`` defaults to the batch).

    ``reuse_cache`` (a ``core.reuse.ReuseCache``) is passed to the UNet,
    which then returns the new cache, and so does this function:
    ``(latents, stats, new_cache)``.  Without it: ``(latents, stats)``.

    ``active`` (B,) bool gates slot serving: inactive rows keep their
    latents (and solver history); their UNet work is discarded and the
    CALLER masks their stats (``LedgerAccum.scatter``).  ``row_stats``
    asks the UNet for per-row counters (``SlotStats``).

    ``bank`` (a tuple of ``solvers.SamplerPolicy``) switches to the per-row
    solver path: ``policy_id`` (B,) selects each row's policy, step
    indices clip to per-row budgets, timesteps, TIPS activity and solver
    coefficients are gathered from the bank's ``SolverTables``, the phase
    threshold scales (when the bank schedules any) go to the UNet as
    ``overrides``, and multistep history rides ``solver_hist`` (B, H, ...).
    The banked return is always ``(latents, stats, new_cache_or_None,
    new_hist)``.
    """
    dev = latents.device
    acp = alphas_cumprod(cfg, dev)
    ts = timestep_schedule(cfg, dev)
    step = cfg.num_train_steps // cfg.num_inference_steps
    b = latents.shape[0]
    step_idx = torch.as_tensor(step_idx, device=dev).to(torch.int64)
    if step_idx.ndim == 0:
        step_idx = step_idx.expand(b)
    if bank is not None:
        bank = solvers_mod.as_bank(bank)
        tables = solvers_mod.solver_tables(bank, cfg, dev)
        policy_id = (torch.zeros((b,), dtype=torch.int64, device=dev)
                     if policy_id is None
                     else torch.as_tensor(policy_id, device=dev)
                     .to(torch.int64))
        if solver_hist is None:
            solver_hist = solvers_mod.init_history(bank, b, latents.shape[1:],
                                                   dev)
        idx = torch.minimum(torch.clamp_min(step_idx, 0),
                            tables.budget[policy_id] - 1)
        t = tables.t[policy_id, idx]              # (B,) per-row timesteps
        tips_vec = tables.tips[policy_id, idx]    # (B,) per-row TIPS flag
    else:
        idx = torch.clamp(step_idx, 0, cfg.num_inference_steps - 1)
        t = ts[idx]                               # (B,) per-row timesteps
        tips_vec = idx < cfg.tips_active_iters    # (B,) per-row TIPS flag
    kw = {} if reuse_cache is None else {"reuse_cache": reuse_cache}
    if row_stats:
        kw["row_stats"] = True
    if bank is not None:
        overrides = solvers_mod.gather_overrides(tables, bank, policy_id,
                                                 idx)
        if overrides is not None:
            kw["overrides"] = overrides
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
    new_cache = out[2] if reuse_cache is not None else None
    if use_cfg:
        eps = guided_eps(eps, cfg.guidance_scale)
    new_hist = None
    if bank is not None:
        new_lat, new_hist = solvers_mod.solver_update(
            latents, eps, solver_hist, tables, bank, policy_id, idx)
    else:
        new_lat = ddim_step(latents, eps, t, t - step, acp)
    if active is not None:
        keep = active.reshape((b,) + (1,) * (latents.ndim - 1))
        new_lat = torch.where(keep, new_lat, latents)
        if new_hist is not None and new_hist.shape[1] > 0:
            new_hist = torch.where(keep[:, None], new_hist, solver_hist)
    if bank is not None:
        return new_lat, stats, new_cache, new_hist
    if reuse_cache is not None:
        return new_lat, stats, new_cache
    return new_lat, stats


def _resolve_bank(sampler_policy, sampler_bank):
    """(bank, steps, policy index) of a banked one-shot run.

    Without ``sampler_bank`` the policy is its own one-entry bank; with it,
    every row runs under the full bank pinned to the policy's index, for
    the policy's own budget, as a slot row of that policy does.
    """
    if sampler_bank is None:
        bank = solvers_mod.as_bank(sampler_policy)
        return bank, solvers_mod.bank_max_steps(bank), 0
    bank = solvers_mod.as_bank(sampler_bank)
    if sampler_policy not in bank:
        raise ValueError(
            f"sampler_policy {sampler_policy.key()} is not an entry of "
            f"sampler_bank {[p.key() for p in bank]}")
    return bank, sampler_policy.num_steps, bank.index(sampler_policy)


def _check_stats_rows(stats_rows, b: int) -> None:
    """``stats_rows`` in [1, b]; under an active mesh a rank whose rows all
    lie past the accounted ones accounts for none (0)."""
    low = 1 if mesh_mod.active_mesh() is None else 0
    if stats_rows is not None and not (low <= stats_rows <= b):
        raise ValueError(f"stats_rows={stats_rows} outside [{low}, {b}]")


def sample_scan(unet_apply, latents, context, uncond_context,
                cfg: DDIMConfig, stats_rows=None, sampler_policy=None,
                sampler_bank=None):
    """All denoising steps as a loop over :func:`denoise_step`.

    Returns ``(latents, stacked UNetStats)`` (leading axis = iterations).

    ``sampler_policy`` (a ``solvers.SamplerPolicy``) swaps the solver and
    the step budget: ``policy.num_steps`` iterations of the banked
    :func:`denoise_step`, history carried.  ``sampler_bank`` (a bank
    holding the policy) runs under the full bank with every row pinned
    to the policy's index: the one-shot oracle of a slot row under that
    bank.
    """
    b = latents.shape[0]
    _check_stats_rows(stats_rows, b)
    if sampler_bank is not None and sampler_policy is None:
        raise ValueError("sampler_bank requires sampler_policy (the "
                         "bank entry to run every row under)")
    per_step = []
    if sampler_policy is not None:
        bank, n, pid0 = _resolve_bank(sampler_policy, sampler_bank)
        policy_id = torch.full((b,), pid0, dtype=torch.int64,
                               device=latents.device)
        hist = solvers_mod.init_history(bank, b, latents.shape[1:],
                                        latents.device)
        for i in range(n):
            latents, stats, _, hist = denoise_step(
                unet_apply, latents, context, uncond_context, i, cfg,
                stats_rows=stats_rows, bank=bank, policy_id=policy_id,
                solver_hist=hist)
            per_step.append(stats)
        return latents, UNetStats.stack(per_step)
    for i in range(cfg.num_inference_steps):
        latents, stats = denoise_step(unet_apply, latents, context,
                                      uncond_context, i, cfg,
                                      stats_rows=stats_rows)
        per_step.append(stats)
    return latents, UNetStats.stack(per_step)


def sample_scan_reuse(unet_apply, latents, context, uncond_context,
                      cfg: DDIMConfig, reuse_cache=None, stats_rows=None,
                      base_caches=None, record_caches: bool = False,
                      sampler_policy=None, sampler_bank=None,
                      policy_id=None):
    """All denoising steps with the temporal-reuse cache threaded.

    * **temporal** — ``reuse_cache`` (typically the all-invalid
      ``core.reuse.reuse_cache_zeros``) is carried: each step reuses the
      PREVIOUS step's activations.  ``record_caches=True`` also keeps
      every step's new cache, in a list indexed by step (the base trace
      of an edit), and returns ``(latents, stats, caches)``.
    * **edit** — ``base_caches`` is such a list from a BASE request: step
      ``i`` reuses the base's step-``i`` activations, which are valid
      from step 0, so ``capacity < 1`` is safe.

    ``sampler_policy`` (and ``sampler_bank``) compose with both modes as
    in :func:`sample_scan`: the banked :func:`denoise_step`, the solver
    history carried beside the cache.  ``policy_id`` (B,) overrides the
    rows' bank index (default: the policy's).  In edit mode the base
    caches must come from a run of the same policy (they are indexed by
    step).

    Returns ``(latents, stacked UNetStats)`` with per-layer reuse
    counters (plus the recorded caches when asked).
    """
    b = latents.shape[0]
    _check_stats_rows(stats_rows, b)
    if (reuse_cache is None) == (base_caches is None):
        raise ValueError(
            "pass exactly one of reuse_cache (temporal mode) or "
            "base_caches (edit mode)")
    if sampler_bank is not None and sampler_policy is None:
        raise ValueError("sampler_bank requires sampler_policy (the "
                         "bank entry to run every row under)")
    bank = hist = None
    if sampler_policy is not None:
        bank, n, pid0 = _resolve_bank(sampler_policy, sampler_bank)
        if policy_id is None:
            policy_id = torch.full((b,), pid0, dtype=torch.int64,
                                   device=latents.device)
        hist = solvers_mod.init_history(bank, b, latents.shape[1:],
                                        latents.device)
    else:
        n = cfg.num_inference_steps
    if base_caches is not None and len(base_caches) != n:
        raise ValueError(f"base_caches holds {len(base_caches)} steps, the "
                         f"schedule {n}")
    per_step, caches = [], []
    cache = reuse_cache
    for i in range(n):
        if base_caches is not None:
            cache = base_caches[i]
        if bank is not None:
            latents, stats, cache, hist = denoise_step(
                unet_apply, latents, context, uncond_context, i, cfg,
                stats_rows=stats_rows, reuse_cache=cache, bank=bank,
                policy_id=policy_id, solver_hist=hist)
        else:
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
