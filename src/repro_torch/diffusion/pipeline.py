"""Text-to-image pipeline and the energy report (port of
``repro.diffusion.pipeline``).

Stages: text encoding -> denoising loop -> VAE decode, the denoiser
resolved from ``cfg.unet`` (a UNet or a DiT config) by
``denoiser.make_denoiser``.  The run measures
per-resolution PSSA compression ratios and per-iteration TIPS
low-precision ratios, which drive the full-geometry analytic ledger to the
paper's headline numbers (EMA GB/iter, mJ/iter).  Slot serving reports
from the integer buckets of a ``stats.LedgerAccum`` instead
(``energy_report_from_accum``, per policy ``energy_report_banked``),
through the same term assembly, so both give the same headline for the
same requests; the cluster router sums its replicas' buckets first
(``merge_ledger_accums``, ``energy_report_cluster``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import energy, pssa
from repro_torch.diffusion import ledger as L
from repro_torch.diffusion import solvers as solvers_mod
from repro_torch.diffusion.denoiser import make_denoiser
from repro_torch.diffusion.sampler import DDIMConfig, sample
from repro_torch.diffusion.stats import (LedgerAccum, UNetStats,
                                         attn_layer_order,
                                         coerce_per_step_stats)
from repro_torch.diffusion.text_encoder import (TextEncoderConfig,
                                                encode_text,
                                                init_text_encoder_params)
from repro_torch.diffusion.unet import UNetConfig
from repro_torch.diffusion.vae import VAEConfig, decode, init_vae_params
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig()   # any denoiser config (UNet or DiT)
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


def init_params(cfg: PipelineConfig, generator=None, device=None) -> dict:
    """Random text-encoder, denoiser and VAE parameters on ``device``
    (``None``: the card); the denoiser's stay under the key ``"unet"``
    whatever its family."""
    device = resolve_device(device)
    if cfg.text.d_model != cfg.unet.context_dim:
        raise ValueError(f"text d_model {cfg.text.d_model} != denoiser "
                         f"context_dim {cfg.unet.context_dim}")
    return {"text": init_text_encoder_params(cfg.text, generator, device),
            "unet": make_denoiser(cfg.unet).init_params(generator, device),
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
        self.denoiser = make_denoiser(cfg.unet)
        if params is None:
            params = init_params(cfg, generator or _default_generator(
                self.device), self.device)
        self.text_params = params["text"]
        self.unet_params = params["unet"]
        self.vae_params = params["vae"]

    def _unet(self, lat, t, ctx, active):
        return self.denoiser.apply(self.unet_params, lat, t, ctx,
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


def measured_sas_ratios(stats_one_iter) -> dict:
    """Per-resolution (compressed / dense) SAS ratio of one iteration."""
    return {res: num / max(den, 1e-12)
            for res, (num, den) in _sas_ratio_terms(stats_one_iter).items()}


def measured_tips_ratio(stats_one_iter) -> float:
    """Workload-weighted INT6 fraction across the iteration's FFNs."""
    num, den = _tips_ratio_terms(stats_one_iter)
    return num / max(den, 1e-12)


def energy_report(cfg: PipelineConfig, stats_per_iter,
                  full_geometry: bool = True,
                  sampler_policy=None) -> "PipelineEnergyReport":
    """Headline numbers (Table I) from one run's stats trajectory.

    ``sampler_policy``: the ``solvers.SamplerPolicy`` the run used, if not
    the config's schedule (its budget and TIPS window then apply).
    """
    return energy_report_multi(cfg, [stats_per_iter],
                               full_geometry=full_geometry,
                               sampler_policy=sampler_policy)


def _fetch_stats(stats_per_batch) -> list:
    """Host copies of each call's trajectory, as per-iteration lists."""
    fetched = []
    for s in stats_per_batch:
        s = s.cpu() if isinstance(s, UNetStats) else [st.cpu() for st in s]
        fetched.append(coerce_per_step_stats(s))
    return fetched


def energy_report_multi(cfg: PipelineConfig, stats_per_batch,
                        full_geometry: bool = True,
                        sampler_policy=None) -> "PipelineEnergyReport":
    """Aggregate report across several calls: per iteration, SAS byte terms
    and row-weighted TIPS terms are summed before dividing.  With
    ``sampler_policy`` every trajectory comes from runs of that policy."""
    fetched = _fetch_stats(stats_per_batch)
    if not fetched:
        raise ValueError("stats_per_batch is empty")
    n = (cfg.ddim.num_inference_steps if sampler_policy is None
         else sampler_policy.num_steps)
    tips_flags = (None if sampler_policy is None else
                  solvers_mod.tips_active_schedule(sampler_policy, cfg.ddim))
    for s in fetched:
        if len(s) != n:
            raise ValueError(
                f"stats trajectory has {len(s)} iterations, "
                f"{'policy' if sampler_policy else 'config'} says {n}")
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
                              full_geometry=full_geometry,
                              num_steps=n, tips_flags=tips_flags)


def aggregated_tips_ratios_per_iter(cfg: PipelineConfig,
                                    stats_per_batch) -> list:
    """Row-weighted per-iteration TIPS low-precision ratios across calls."""
    fetched = _fetch_stats(stats_per_batch)
    out = []
    for i in range(cfg.ddim.num_inference_steps):
        num = den = 0.0
        for s in fetched:
            a, b = _tips_ratio_terms(s[i])
            num, den = num + a, den + b
        out.append(num / max(den, 1e-12))
    return out


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


def reuse_ratios_from_accum(cfg: PipelineConfig, accum) -> list:
    """Per-iteration realized temporal-reuse ratio from a ``LedgerAccum``:
    ``1 - computed/total`` over the bucket's reuse counters summed across
    layers and accounted rows.  Integers in, one division out, so slot
    count and admission order cannot move it.  A bucket with no reuse
    work (a dense run, a step not reached yet) reads 0.0."""
    comp, tot = accum.reuse_computed.cpu(), accum.reuse_total.cpu()
    out = []
    for i in range(cfg.ddim.num_inference_steps):
        t = float(tot[i].sum())
        out.append(0.0 if t == 0.0 else 1.0 - float(comp[i].sum()) / t)
    return out


def _report_from_terms(cfg: PipelineConfig, per_iter_terms,
                       full_geometry: bool = True,
                       num_steps: Optional[int] = None,
                       tips_flags=None) -> "PipelineEnergyReport":
    """Per-iteration aggregated terms -> the full-geometry ledger report.

    ``per_iter_terms``: one ``(sas_terms, (tips_num, tips_den))`` per
    iteration, ``sas_terms`` mapping resolution to summed (compressed,
    baseline) bytes: the shared tail of the per-call stats path and the
    accumulator path.  ``num_steps`` / ``tips_flags``: a policy's budget
    and per-iteration TIPS activity (default: the config's schedule and
    ``i < tips_active_iters``); ``cfg.unet.tips`` still gates both.  The
    geometry is the family's ``full_geometry()`` and its measured ratios
    are keyed by ``attn_resolutions()`` (denoiser-contract hooks).
    """
    n = cfg.ddim.num_inference_steps if num_steps is None else num_steps
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
        tips_on = (i < cfg.ddim.tips_active_iters if tips_flags is None
                   else bool(tips_flags[i]))
        opts_per_iter.append(L.LedgerOptions(
            pssa=cfg.unet.pssa,
            tips=cfg.unet.tips and tips_on,
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


def ledger_terms_from_accum(cfg: PipelineConfig, accum) -> list:
    """Per-iteration ledger terms from a slot-serving ``LedgerAccum``.

    The same (SAS byte, TIPS workload) terms :func:`energy_report_multi`
    derives from per-call stats, through the same byte arithmetic
    (``pssa.stats_from_counters``), so slot count, admission order and
    occupancy cannot move a term.
    """
    planes = _fetch_accum(accum)
    n = cfg.ddim.num_inference_steps
    want = (n, len(attn_layer_order(cfg.unet)))
    if tuple(planes[0].shape) != want:
        raise ValueError(f"accumulator shape {tuple(planes[0].shape)} does "
                         f"not match {want}")
    return _terms_from_counters(cfg, *planes, 0, n)


def _fetch_accum(accum):
    """One host copy of the four SAS/TIPS counter planes."""
    return tuple(x.cpu() for x in (accum.nnz, accum.ones_xor, accum.imp,
                                   accum.rows))


def _terms_from_counters(cfg: PipelineConfig, nnz, ones_xor, imp, rows,
                         start: int, n: int) -> list:
    """Buckets ``[start, start + n)`` -> per-iteration ledger terms (the
    legacy accumulator at ``start = 0``, a banked policy's block at
    ``start = policy_index * bank_max_steps``)."""
    layers = attn_layer_order(cfg.unet)
    heads = cfg.unet.num_heads
    per_iter_terms = []
    for i in range(start, start + n):
        sas_terms: dict = {}
        tnum = tden = 0.0
        r = int(rows[i])
        for li, lk in enumerate(layers):
            if r == 0:
                continue                  # nothing accounted yet
            res = lk.resolution
            tq = res * res
            st = pssa.stats_from_counters(
                nnz[i, li], ones_xor[i, li], lead=r * heads, tq=tq, tk=tq,
                patch=cfg.unet.patch_size(res))
            num, den = sas_terms.get(res, (0.0, 0.0))
            sas_terms[res] = (num + float(st.bytes_pssa_total),
                              den + float(st.bytes_baseline))
            # per call the one-shot path sums (1 - imp_c/(rows_c*Tq)) *
            # Tq * rows_c; with exact per-call folds (power-of-two
            # rows_c * Tq) that is the INTEGER Tq*rows - imp
            tnum += float(tq * r - int(imp[i, li]))
            tden += float(tq * r)
        per_iter_terms.append((sas_terms, (tnum, tden)))
    return per_iter_terms


def banked_ledger_terms(cfg: PipelineConfig, accum, bank) -> list:
    """Per-policy per-iteration ledger terms from a BANKED ``LedgerAccum``:
    policy ``p``'s trajectory is the bucket block ``[p*N, p*N +
    budget_p)`` (N = the bank's largest budget), in bank order."""
    bank = solvers_mod.as_bank(bank)
    planes = _fetch_accum(accum)
    n_max = solvers_mod.bank_max_steps(bank)
    want = (len(bank) * n_max, len(attn_layer_order(cfg.unet)))
    if tuple(planes[0].shape) != want:
        raise ValueError(f"accumulator shape {tuple(planes[0].shape)} does "
                         f"not match banked layout {want}")
    return [_terms_from_counters(cfg, *planes, p * n_max, pol.num_steps)
            for p, pol in enumerate(bank)]


def energy_report_banked(cfg: PipelineConfig, accum, bank,
                         full_geometry: bool = True
                         ) -> "BankedEnergyReport":
    """Per-policy + aggregate energy report for a banked serving run.

    Each policy's buckets go through the same term assembly and ledger as
    a run of that policy alone, so every per-policy headline equals
    serving its requests one-shot.  A policy whose step-0 bucket saw no
    row reports ``images == 0`` and no report.
    """
    bank = solvers_mod.as_bank(bank)
    terms = banked_ledger_terms(cfg, accum, bank)
    rows = accum.rows.cpu()
    n_max = solvers_mod.bank_max_steps(bank)
    entries = []
    for p, (pol, t) in enumerate(zip(bank, terms)):
        # every admitted request visits its step-0 bucket once
        images = int(rows[p * n_max])
        report = None
        if images > 0:
            report = _report_from_terms(
                cfg, t, full_geometry=full_geometry,
                num_steps=pol.num_steps,
                tips_flags=solvers_mod.tips_active_schedule(pol, cfg.ddim))
        entries.append(BankedPolicyReport(policy=pol, images=images,
                                          report=report))
    return BankedEnergyReport(entries=tuple(entries))


def energy_report_from_accum(cfg: PipelineConfig, accum,
                             full_geometry: bool = True
                             ) -> "PipelineEnergyReport":
    """Energy report for a drained slot-serving run (DESIGN.md §8): equal
    to :func:`energy_report_multi` over the same requests served one-shot
    whenever the per-call float folds are exact (power-of-two accounted
    rows per call)."""
    return _report_from_terms(cfg, ledger_terms_from_accum(cfg, accum),
                              full_geometry=full_geometry)


def merge_ledger_accums(accums) -> LedgerAccum:
    """Sum per-replica ``LedgerAccum``s into one cluster accumulator
    (DESIGN.md §13).

    Every replica scatters integer counters into the same bucket layout,
    and integer addition is exact, associative and commutative: the
    merged accumulator, and every report from it, is the same at any
    replica count, routing decision or admission order that serves the
    same requests.  All six int64 planes are summed, field by field, on
    the first accumulator's device (replicas on other cards are copied
    there).
    """
    accums = list(accums)
    if not accums:
        raise ValueError("merge_ledger_accums: no accumulators")
    shapes = {tuple(a.nnz.shape) for a in accums}
    if len(shapes) > 1:
        raise ValueError(
            f"merge_ledger_accums: mismatched bucket layouts {shapes} — "
            f"replicas must share one bank/schedule")
    dev = accums[0].nnz.device
    return LedgerAccum(**{
        f.name: sum((getattr(a, f.name).to(dev) for a in accums[1:]),
                    getattr(accums[0], f.name))
        for f in dataclasses.fields(LedgerAccum)})


def energy_report_cluster(cfg: PipelineConfig, accums, bank=None,
                          full_geometry: bool = True):
    """Energy report for a multi-replica (cluster-router) run: the
    replicas' accumulators merged by :func:`merge_ledger_accums`, then
    reported as one slot-serving run (:func:`energy_report_banked` under a
    ``bank``, :func:`energy_report_from_accum` otherwise), so the headline
    equals one replica's, and the same requests served one-shot."""
    merged = merge_ledger_accums(accums)
    if bank is not None:
        return energy_report_banked(cfg, merged, bank,
                                    full_geometry=full_geometry)
    return energy_report_from_accum(cfg, merged,
                                    full_geometry=full_geometry)


def phase_breakdown_from_accum(cfg: PipelineConfig, accum, bank) -> list:
    """Per-policy, per-phase realized ratios from a banked accumulator:
    each policy's terms grouped by ``solvers.phase_index_schedule`` and
    summed within the phase before dividing.  Returns, per bank entry,
    ``{"policy", "phases": [{"phase", "iters", "sas_ratio",
    "tips_low_ratio"}, ...]}``."""
    out = []
    bank = solvers_mod.as_bank(bank)
    for pol, terms in zip(bank, banked_ledger_terms(cfg, accum, bank)):
        phase_ids = solvers_mod.phase_index_schedule(pol)
        groups: dict = {}
        for i, (sas_terms, (tnum, tden)) in enumerate(terms):
            g = groups.setdefault(phase_ids[i], [0, {}, 0.0, 0.0])
            g[0] += 1
            for res, (num, den) in sas_terms.items():
                a, b = g[1].get(res, (0.0, 0.0))
                g[1][res] = (a + num, b + den)
            g[2] += tnum
            g[3] += tden
        phases = []
        for ph in sorted(groups):
            iters, sas, tnum, tden = groups[ph]
            snum = sum(n for n, _ in sas.values())
            sden = sum(d for _, d in sas.values())
            phases.append({
                "phase": ph, "iters": iters,
                "sas_ratio": snum / max(sden, 1e-12),
                "tips_low_ratio": tnum / max(tden, 1e-12)})
        out.append({"policy": pol.key(), "phases": phases})
    return out


def tips_ratios_from_accum(cfg: PipelineConfig, accum) -> list:
    """Per-iteration realized INT6 row fraction from the accumulator."""
    return [num / max(den, 1e-12)
            for _, (num, den) in ledger_terms_from_accum(cfg, accum)]


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


@dataclasses.dataclass
class BankedPolicyReport:
    """One bank entry's share of a banked serving run: ``images`` ran
    under ``policy`` (its step-0 bucket's row count); ``report`` is None
    when it served nothing."""
    policy: object                            # solvers.SamplerPolicy
    images: int
    report: Optional[PipelineEnergyReport]

    @property
    def mj_per_image(self) -> float:
        """Modeled energy per image at THIS policy's step budget."""
        if self.report is None:
            return 0.0
        return self.report.mj_per_iter_with_ema * self.policy.num_steps


@dataclasses.dataclass
class BankedEnergyReport:
    """Per-policy energy reports + the images-weighted aggregate."""
    entries: tuple                            # of BankedPolicyReport

    @property
    def images(self) -> int:
        return sum(e.images for e in self.entries)

    @property
    def mj_per_image(self) -> float:
        """Images-weighted mean energy per image across the bank."""
        total = self.images
        if total == 0:
            return 0.0
        return sum(e.mj_per_image * e.images for e in self.entries) / total

    def summary(self) -> dict:
        return {
            "images": self.images,
            "mj_per_image_weighted": self.mj_per_image,
            "per_policy": [
                {"policy": e.policy.key(),
                 "tier": e.policy.name or None,
                 "num_steps": e.policy.num_steps,
                 "images": e.images,
                 "mj_per_image": e.mj_per_image,
                 **({} if e.report is None else e.report.summary())}
                for e in self.entries],
        }
