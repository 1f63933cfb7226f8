"""Plain reference of one request: encode the prompt and the empty prompt,
run the solver with classifier-free guidance, decode the final latents.

Solvers: DDIM (eta = 0) and DPM-Solver++(2M) in data-prediction space
with the lower-order first and final steps, over a linear-beta DDPM
schedule with uniformly spaced timesteps.  TIPS is open for the first
``tips_active_iters`` steps of the configured budget, scaled to the
policy's budget otherwise (at least one).
"""
from __future__ import annotations

import importlib

import torch

from . import text, vae

TIERS = {"draft": ("dpm2m", 8), "balanced": ("dpm2m", 12),
         "quality": ("ddim", 25)}


def alphas_cumprod(ddim: dict, device) -> torch.Tensor:
    betas = torch.linspace(ddim["beta_start"] ** 0.5, ddim["beta_end"] ** 0.5,
                           ddim["num_train_steps"], dtype=torch.float32,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def schedule(solver: str, n: int, ddim: dict, device):
    """Per-step (t, coefficients, TIPS flag) of one policy."""
    acp = alphas_cumprod(ddim, device)
    step = ddim["num_train_steps"] // n
    ts = torch.arange(n - 1, -1, -1, device=device) * step
    t_prev = ts - step
    a_t = acp[ts]
    a_prev = torch.where(t_prev >= 0, acp[torch.clamp_min(t_prev, 0)],
                         torch.ones((), device=device))
    if n == ddim["num_inference_steps"]:
        active = ddim["tips_active_iters"]
    else:
        active = max(1, n * ddim["tips_active_iters"]
                     // ddim["num_inference_steps"])
    sched = {"t": ts, "a_t": a_t, "a_prev": a_prev,
             "tips": [i < active for i in range(n)]}
    if solver == "dpm2m":
        alpha_c, sigma_c = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        alpha_n, sigma_n = torch.sqrt(a_prev), torch.sqrt(1.0 - a_prev)
        h = torch.log(alpha_n / sigma_n) - torch.log(alpha_c / sigma_c)
        i = torch.arange(n, device=device)
        sched.update(
            c_lat=sigma_n / sigma_c, c_d=-alpha_n * torch.expm1(-h),
            m2=torch.where((i == 0) | (i == n - 1),
                           torch.zeros((), device=device),
                           h / (2.0 * torch.cat([h[:1], h[:-1]]))))
    return sched


def family(name: str):
    """The reference module of a denoiser family."""
    return importlib.import_module(f"{__package__}.{name}")


@torch.no_grad()
def generate(weights: dict, model: dict, tokens, uncond, latents,
             tier: str, dense: bool = False):
    """One request alone: (image (1, 8S, 8S, 3), counters (steps, L, 3)).

    ``model`` is the configuration file's content; ``tier`` a name in
    ``TIERS`` or ``"config"`` (the configuration's own DDIM schedule).
    Counters are each step's (nnz, ones_xor, important) of the cond row.
    """
    ddim = model["ddim"]
    if tier == "config":
        solver, n = "ddim", ddim["num_inference_steps"]
    else:
        solver, n = TIERS[tier]
    fam = family(model["family"])
    dev = latents.device
    context = torch.cat([text.encode(weights["text"], tokens, model["text"]),
                         text.encode(weights["text"], uncond, model["text"])])
    sc = schedule(solver, n, ddim, dev)
    lat = latents.to(torch.float32)
    x0_prev = torch.zeros_like(lat)
    g = ddim["guidance_scale"]
    per_step = []
    for i in range(n):
        lat2 = torch.cat([lat, lat])
        t2 = sc["t"][i].reshape(1).expand(2)
        tips_on = torch.full((2,), sc["tips"][i], dtype=torch.bool,
                             device=dev)
        eps2, counters = fam.forward(weights["unet"], lat2, t2, context,
                                     model["unet"], model["features"],
                                     tips_on, 1, dense=dense)
        eps = eps2[1:] + g * (eps2[:1] - eps2[1:])
        a_t, a_prev = sc["a_t"][i], sc["a_prev"][i]
        x0 = (lat - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if solver == "ddim":
            lat = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        else:
            m2 = sc["m2"][i]
            d = (1.0 + m2) * x0 - m2 * x0_prev
            lat = sc["c_lat"][i] * lat + sc["c_d"][i] * d
            x0_prev = x0
        if not dense:
            per_step.append(torch.stack([torch.stack(c) for c in counters]
                                        ).reshape(len(counters), 3))
    image = vae.decode(weights["vae"], lat, model["vae"])
    return image, (torch.stack(per_step) if per_step else None)
