"""Text-to-image pipeline and the energy report (port of
``repro.diffusion.pipeline``).

Stages: text encoding -> denoising loop -> VAE decode.  The run measures
per-resolution PSSA compression ratios and per-iteration TIPS
low-precision ratios, which drive the full-geometry analytic ledger to the
paper's headline numbers (EMA GB/iter, mJ/iter).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import energy
from repro_torch.diffusion import ledger as L
from repro_torch.diffusion.sampler import DDIMConfig, sample
from repro_torch.diffusion.stats import UNetStats, coerce_per_step_stats
from repro_torch.diffusion.text_encoder import (TextEncoderConfig,
                                                encode_text,
                                                init_text_encoder_params)
from repro_torch.diffusion.unet import (UNetConfig, init_unet_params,
                                        unet_forward)
from repro_torch.diffusion.vae import VAEConfig, decode, init_vae_params
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig()
    text: TextEncoderConfig = TextEncoderConfig()
    vae: VAEConfig = VAEConfig()
    ddim: DDIMConfig = DDIMConfig()

    @staticmethod
    def smoke() -> "PipelineConfig":
        return PipelineConfig(
            unet=UNetConfig().smoke(),
            text=TextEncoderConfig().smoke(),
            vae=VAEConfig().smoke(),
            ddim=DDIMConfig(num_inference_steps=3, guidance_scale=1.0,
                            tips_active_iters=2),
        )


def init_params(cfg: PipelineConfig, generator=None, device="cpu") -> dict:
    """Random text-encoder, UNet and VAE parameters on ``device``."""
    if cfg.text.d_model != cfg.unet.context_dim:
        raise ValueError(f"text d_model {cfg.text.d_model} != UNet "
                         f"context_dim {cfg.unet.context_dim}")
    return {"text": init_text_encoder_params(cfg.text, generator, device),
            "unet": init_unet_params(cfg.unet, generator, device),
            "vae": init_vae_params(cfg.vae, generator, device)}


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


class StableDiffusionPipeline:
    """The per-step reference path: a Python loop with two UNet calls per
    step under CFG.  ``DiffusionEngine`` is the production path; both feed
    the same ``energy_report``.

    ``device=None`` means the card; ``params`` (from ``init_params`` or
    ``repro_torch.convert``) default to random ones drawn from
    ``generator``.
    """

    def __init__(self, cfg: PipelineConfig, device=None, params=None,
                 generator=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, generator or _default_generator(
                self.device), self.device)
        self.text_params = params["text"]
        self.unet_params = params["unet"]
        self.vae_params = params["vae"]

    def _unet(self, lat, t, ctx, active):
        return unet_forward(self.unet_params, lat, t, ctx, self.cfg.unet,
                            tips_active=active)

    @torch.no_grad()
    def generate(self, prompt_tokens, generator=None, uncond_tokens=None,
                 latents=None, collect_stats: bool = True):
        """prompt_tokens (B, text_len) -> (image, stats_per_iter)."""
        cfg = self.cfg
        prompt_tokens = torch.as_tensor(prompt_tokens, device=self.device)
        context = encode_text(self.text_params, prompt_tokens, cfg.text)
        uncond = None
        if uncond_tokens is not None:
            uncond = encode_text(self.text_params, torch.as_tensor(
                uncond_tokens, device=self.device), cfg.text)
        if latents is None:
            s = cfg.unet.latent_size
            latents = torch.randn(
                (prompt_tokens.shape[0], s, s, cfg.unet.in_channels),
                generator=generator, device=self.device)
        latents, stats = sample(self._unet, latents.to(self.device), context,
                                uncond, cfg.ddim,
                                collect_stats=collect_stats)
        return decode(self.vae_params, latents, cfg.vae), stats


def _iter_layer_stats(stats_one_iter: UNetStats, kind: str):
    """Yield (resolution, per-layer stats) of one iteration."""
    for lk, st in zip(stats_one_iter.layers, getattr(stats_one_iter, kind)):
        yield lk.resolution, st


def _sas_ratio_terms(stats_one_iter) -> dict:
    """Per-resolution (compressed, baseline) byte sums for the SAS ratio."""
    by_res: dict = {}
    for res, st in _iter_layer_stats(stats_one_iter, "pssa"):
        num, den = by_res.get(res, (0.0, 0.0))
        by_res[res] = (num + float(st.bytes_pssa_total),
                       den + float(st.bytes_baseline))
    return by_res


def _tips_ratio_terms(stats_one_iter) -> tuple:
    """(numerator, denominator) of the workload-weighted INT6 fraction;
    the weight carries the accounted row count."""
    num = den = 0.0
    for res, tr in _iter_layer_stats(stats_one_iter, "tips"):
        rows = float(tr.important.shape[0]) if tr.important.ndim >= 2 else 1.0
        work = float(res * res) * rows
        num += float(tr.low_precision_ratio) * work
        den += work
    return num, den


def energy_report(cfg: PipelineConfig, stats_per_iter,
                  full_geometry: bool = True) -> "PipelineEnergyReport":
    """Headline numbers (Table I) from one run's stats trajectory."""
    return energy_report_multi(cfg, [stats_per_iter],
                               full_geometry=full_geometry)


def energy_report_multi(cfg: PipelineConfig, stats_per_batch,
                        full_geometry: bool = True
                        ) -> "PipelineEnergyReport":
    """Aggregate report across several calls: per iteration, SAS byte terms
    and row-weighted TIPS terms are summed before dividing."""
    fetched = []
    for s in stats_per_batch:
        s = s.cpu() if isinstance(s, UNetStats) else [st.cpu() for st in s]
        fetched.append(coerce_per_step_stats(s))
    if not fetched:
        raise ValueError("stats_per_batch is empty")
    n = cfg.ddim.num_inference_steps
    for s in fetched:
        if len(s) != n:
            raise ValueError(f"stats trajectory has {len(s)} iterations, "
                             f"config says {n}")
    per_iter_terms = []
    for i in range(n):
        sas_terms: dict = {}
        tnum = tden = 0.0
        for s in fetched:
            for res, (num, den) in _sas_ratio_terms(s[i]).items():
                a, b = sas_terms.get(res, (0.0, 0.0))
                sas_terms[res] = (a + num, b + den)
            num, den = _tips_ratio_terms(s[i])
            tnum, tden = tnum + num, tden + den
        per_iter_terms.append((sas_terms, (tnum, tden)))
    return _report_from_terms(cfg, per_iter_terms,
                              full_geometry=full_geometry)


def aggregated_reuse_ratios_per_iter(cfg: PipelineConfig,
                                     stats_per_batch) -> list:
    """Per-iteration realized reuse ratio, 1 - computed/total, across
    several calls' stacked ``UNetStats`` (what ``sample_scan_reuse``
    returns).  Integer counters are summed over calls and layers before
    the one division; dense trajectories (empty ``reuse``) contribute
    nothing, and an iteration with no reuse work reads 0.0."""
    out = []
    for i in range(cfg.ddim.num_inference_steps):
        num = den = 0
        for s in stats_per_batch:
            for c in (s.reuse if isinstance(s, UNetStats) else ()):
                num += int(c.computed[i].sum())
                den += int(c.total[i].sum())
        out.append(0.0 if den == 0 else 1.0 - num / den)
    return out


def _report_from_terms(cfg: PipelineConfig, per_iter_terms,
                       full_geometry: bool = True
                       ) -> "PipelineEnergyReport":
    """Per-iteration aggregated terms -> the full-geometry ledger report."""
    n = cfg.ddim.num_inference_steps
    if len(per_iter_terms) != n:
        raise ValueError(
            f"{len(per_iter_terms)} iteration terms, schedule says {n}")
    geom = cfg.unet.full_geometry() if full_geometry else cfg.unet
    geom_res = list(geom.attn_resolutions())

    def remap(ratios: dict) -> dict:
        meas = sorted(ratios, reverse=True)
        return {g: ratios[m] for g, m in zip(geom_res, meas)}

    opts_per_iter = []
    for i, (sas_terms, (tnum, tden)) in enumerate(per_iter_terms):
        sas_ratio = {res: num / max(den, 1e-12)
                     for res, (num, den) in sas_terms.items()}
        opts_per_iter.append(L.LedgerOptions(
            pssa=cfg.unet.pssa,
            tips=cfg.unet.tips and i < cfg.ddim.tips_active_iters,
            sas_ratio=remap(sas_ratio),
            tips_low_ratio=tnum / max(tden, 1e-12),
            tips_mid=cfg.unet.precision.ffn_mid,
        ))
    baseline_opts = [L.LedgerOptions()] * n
    return PipelineEnergyReport(
        optimized=L.generation_report(geom, opts_per_iter),
        baseline=L.generation_report(geom, baseline_opts),
        iterations=n,
    )


@dataclasses.dataclass
class PipelineEnergyReport:
    optimized: energy.EnergyReport
    baseline: energy.EnergyReport
    iterations: int

    @property
    def ema_gb_per_iter_baseline(self) -> float:
        return self.baseline.ema_bytes_total / self.iterations / 1e9

    @property
    def ema_reduction(self) -> float:
        return 1.0 - (self.optimized.ema_bytes_total
                      / self.baseline.ema_bytes_total)

    @property
    def mj_per_iter_with_ema(self) -> float:
        return self.optimized.total_mj / self.iterations

    @property
    def mj_per_iter_compute(self) -> float:
        return self.optimized.compute_energy_mj / self.iterations

    def summary(self) -> dict:
        return {
            "ema_gb_per_iter_baseline": self.ema_gb_per_iter_baseline,
            "ema_gb_per_iter_optimized":
                self.optimized.ema_bytes_total / self.iterations / 1e9,
            "total_ema_reduction": self.ema_reduction,
            "sas_fraction_of_ema_baseline": self.baseline.sas_fraction,
            "transformer_ema_fraction_baseline":
                self.baseline.stage_fraction("self_attn", "cross_attn",
                                             "ffn"),
            "self_attn_fraction_of_transformer":
                (self.baseline.ema_bytes_by_stage.get("self_attn", 0.0)
                 / max(sum(self.baseline.ema_bytes_by_stage.get(s, 0.0)
                           for s in ("self_attn", "cross_attn", "ffn")),
                       1e-12)),
            "mj_per_iter_compute": self.mj_per_iter_compute,
            "mj_per_iter_with_ema": self.mj_per_iter_with_ema,
        }
