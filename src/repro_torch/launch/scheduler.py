"""Continuous-batching scheduler over the slot-state DiffusionEngine (port
of ``repro.launch.scheduler``; DESIGN.md §8).

The micro-batching front-end drains fixed batches: a request arriving
while a batch runs waits the batch's whole generation.  The continuous
scheduler keeps a slot batch in flight (``DiffusionEngine.init_slots`` /
``slot_step``): every step advances all occupied slots, each at its own
iteration, and between steps finished rows are decoded and retired and
queued requests admitted into the freed slots.  A new request starts one
denoising step away instead of one generation away.

Determinism contract: a request's image equals the one-shot engine's at
the same latents and batch size (on the card, rows follow the batch's row
count: ROADMAP.md Queue 3 item 17), and the drained ``LedgerAccum`` gives
the same energy headline as the same requests served one-shot; slot
count, arrival order and occupancy cannot move a counter.

Both schedulers share the request and trace vocabulary, so they are
compared under identical traces:

``ContinuousScheduler``  slot-based in-flight batching
``FixedBatchScheduler``  the micro-batching baseline, same arrival gating

Requests draw their tokens and latents from a generator of their own,
seeded from ``(seed, index)`` on the CPU: a request's inputs depend on
neither the number of requests, the scheduler nor the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import tips
from repro_torch.diffusion import solvers
from repro_torch.diffusion.pipeline import (aggregated_tips_ratios_per_iter,
                                            energy_report_banked,
                                            energy_report_from_accum,
                                            energy_report_multi,
                                            phase_breakdown_from_accum,
                                            reuse_ratios_from_accum,
                                            tips_ratios_from_accum)
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass
class Request:
    """One text-to-image request flowing through a scheduler."""
    rid: int
    tokens: object                  # (1, text_len) int32 prompt tokens
    arrival_s: float                # seconds after serving start
    latents: object = None          # (1, S, S, C) initial noise (per-request)
    uncond_tokens: object = None    # (1, text_len) or None (CFG off)
    policy_index: int = 0           # SamplerPolicy slot in the serving bank
    tier: str = ""                  # quality-tier label (trace bookkeeping)
    edit_window: object = None      # (y0, x0, h, w) latent px (edit requests)
    # filled by the scheduler:
    admitted_s: Optional[float] = None
    finished_s: Optional[float] = None
    image: object = None            # (8S, 8S, 3) numpy
    # filled by the cluster router (launch.router):
    replica: Optional[int] = None   # replica that served the request
    degraded_from: str = ""         # original tier label if SLO-degraded
    arrival_round: Optional[int] = None   # router round of arrival
    finish_round: Optional[int] = None    # router round the image finished
    previews: int = 0               # progressive preview decodes streamed
    first_preview_s: Optional[float] = None  # time-to-first-pixel proxy

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    @property
    def queue_s(self) -> Optional[float]:
        if self.admitted_s is None:
            return None
        return self.admitted_s - self.arrival_s


def request_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of draw ``index`` under ``seed``."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def _uncond(cfg, use_cfg, device):
    return (torch.zeros((1, cfg.text.max_len), dtype=torch.int32,
                        device=device) if use_cfg else None)


def make_requests(cfg, n: int, seed: int = 7, use_cfg: Optional[bool] = None,
                  bank=None, device=None) -> list:
    """n requests, each with prompt tokens and initial latents drawn from
    ``request_generator(seed, i)`` and moved to ``device`` (``None``: the
    card).  Arrivals start at 0; apply a trace with :func:`apply_trace`.

    ``bank`` (tuple of ``solvers.SamplerPolicy``): request ``i`` carries
    ``policy_index = i % len(bank)`` and that policy's label as its tier.
    """
    device = resolve_device(device)
    if use_cfg is None:
        use_cfg = cfg.ddim.guidance_scale != 1.0
    s, c = cfg.unet.latent_size, cfg.unet.in_channels
    reqs = []
    for i in range(n):
        g = request_generator(seed, i)
        toks = torch.randint(0, cfg.text.vocab_size, (1, cfg.text.max_len),
                             generator=g, dtype=torch.int32)
        lat = torch.randn((1, s, s, c), generator=g)
        pidx = i % len(bank) if bank else 0
        reqs.append(Request(rid=i, tokens=toks.to(device), arrival_s=0.0,
                            latents=lat.to(device),
                            uncond_tokens=_uncond(cfg, use_cfg, device),
                            policy_index=pidx,
                            tier=bank[pidx].label() if bank else ""))
    return reqs


def make_edit_requests(cfg, n: int, seed: int = 7,
                       use_cfg: Optional[bool] = None,
                       edit_fraction: float = 0.25, device=None) -> list:
    """n img2img/edit requests: one base latent (drawn from
    ``request_generator(seed, 0)``), each request re-noised inside its own
    ``edit_fraction``-sided square window (request ``i`` draws its tokens,
    window and noise from ``request_generator(seed, 1 + i)``).

    Each request records its window as ``edit_window`` (``(y0, x0, h,
    w)`` in latent pixels), the a-priori knowledge an edit front-end has.
    """
    device = resolve_device(device)
    if use_cfg is None:
        use_cfg = cfg.ddim.guidance_scale != 1.0
    s, c = cfg.unet.latent_size, cfg.unet.in_channels
    base = torch.randn((1, s, s, c), generator=request_generator(seed, 0))
    w = max(1, int(round(edit_fraction * s)))
    reqs = []
    for i in range(n):
        g = request_generator(seed, 1 + i)
        toks = torch.randint(0, cfg.text.vocab_size, (1, cfg.text.max_len),
                             generator=g, dtype=torch.int32)
        yi, xi = (int(v) for v in torch.randint(0, s - w + 1, (2,),
                                                generator=g))
        patch = torch.randn((1, w, w, c), generator=g)
        lat = base.clone()
        lat[:, yi:yi + w, xi:xi + w, :] = (
            base[:, yi:yi + w, xi:xi + w, :] * 0.5 + patch)
        reqs.append(Request(rid=i, tokens=toks.to(device), arrival_s=0.0,
                            latents=lat.to(device),
                            uncond_tokens=_uncond(cfg, use_cfg, device),
                            edit_window=(yi, xi, w, w)))
    return reqs


def micro_batches(requests: torch.Tensor, batch: int) -> list:
    """Pack request rows into fixed-size batches, padding the tail.

    Returns (batched rows, valid count) pairs; padded rows repeat the
    chunk's first row.  ``valid`` drives the images/s accounting and the
    ``stats_rows`` ledger restriction downstream.
    """
    n = requests.shape[0]
    out = []
    for i in range(0, n, batch):
        chunk = requests[i:i + batch]
        valid = chunk.shape[0]
        if valid < batch:
            pad = chunk[:1].expand((batch - valid,) + tuple(chunk.shape[1:]))
            chunk = torch.cat([chunk, pad], dim=0)
        out.append((chunk, valid))
    return out


def bursty_trace(n: int, burst: int, gap_s: float, start_s: float = 0.0
                 ) -> list:
    """Deterministic bursty arrivals: ``burst`` requests every ``gap_s``."""
    return [start_s + (i // max(burst, 1)) * gap_s for i in range(n)]


def poisson_trace(n: int, rate_per_s: float, seed: int = 0) -> list:
    """Poisson arrivals at ``rate_per_s`` (cumulative exponential gaps)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
    return list(np.cumsum(gaps))


def apply_trace(requests: list, arrivals: list) -> list:
    for r, a in zip(requests, arrivals):
        r.arrival_s = float(a)
    return requests


def poll_arrivals(pending: list, ready: list, now: float) -> None:
    """Move every request whose ``arrival_s`` has passed onto ``ready``.

    ``pending`` must be sorted by ``(arrival_s, rid)``; FIFO order within
    the ready queue follows from that sort.
    """
    while pending and pending[0].arrival_s <= now:
        ready.append(pending.pop(0))


def _lat_summary(lats) -> dict:
    lats = np.asarray(lats, dtype=np.float64)
    return {
        "mean": float(lats.mean()),
        "p50": float(np.percentile(lats, 50)),
        "p95": float(np.percentile(lats, 95)),
        "max": float(lats.max()),
    }


def _latency_metrics(requests: list, makespan_s: float,
                     bank=None, default_steps: int = 0) -> dict:
    lats = [r.latency_s for r in requests]
    queues = np.asarray([r.queue_s for r in requests], dtype=np.float64)
    out = {
        "requests": len(requests),
        "makespan_s": makespan_s,
        "goodput_imgs_per_s": len(requests) / max(makespan_s, 1e-9),
        "latency_s": _lat_summary(lats),
        "queue_wait_s": {
            "mean": float(queues.mean()),
            "p95": float(np.percentile(queues, 95)),
        },
    }
    # denoising steps completed per second: the tier-neutral throughput
    # when step budgets are mixed
    steps_of = (lambda r: bank[r.policy_index].num_steps) if bank \
        else (lambda r: default_steps)
    total_steps = sum(steps_of(r) for r in requests)
    if total_steps:
        out["goodput_steps_per_s"] = total_steps / max(makespan_s, 1e-9)
    tiers = sorted({r.tier for r in requests if r.tier})
    if tiers:
        out["per_tier"] = {
            t: {"requests": sum(r.tier == t for r in requests),
                "latency_s": _lat_summary(
                    [r.latency_s for r in requests if r.tier == t])}
            for t in tiers}
    degraded = sorted({r.degraded_from for r in requests if r.degraded_from})
    if degraded:
        out["degraded_per_tier"] = {
            t: sum(r.degraded_from == t for r in requests) for t in degraded}
        out["degraded_requests"] = sum(bool(r.degraded_from)
                                       for r in requests)
    return out


class ContinuousScheduler:
    """Slot-based in-flight scheduler (continuous batching).

    ``engine`` is a ``DiffusionEngine``; ``num_slots`` fixes the slot
    batch for the whole run.  ``run`` drives a request list with
    wall-clock arrival gating: a request becomes admissible once ``now >=
    arrival_s``, enters the first free slot between steps, and its image
    is decoded the step its slot finishes.

    ``bank`` (tuple of ``solvers.SamplerPolicy``; ``None``: the engine's
    ``policies`` bank) turns on mixed-tier serving: each request's
    ``policy_index`` picks its solver and step budget, all inside one
    ``slot_step``.
    """

    def __init__(self, engine, num_slots: int, bank=None):
        self.engine = engine
        self.num_slots = num_slots
        if bank is None:
            bank = engine.policies.bank
        self.bank = solvers.as_bank(bank) if bank is not None else None

    def warmup(self) -> float:
        """One admit, one step and every power-of-two retirement decode a
        run can hit, off the clock (lazily built kernels, cuDNN plans).
        Returns the wall seconds."""
        eng = self.engine
        t0 = time.perf_counter()
        state = eng.init_slots(self.num_slots, bank=self.bank)
        toks = torch.zeros((1, eng.cfg.text.max_len), dtype=torch.int32,
                           device=eng.device)
        un = toks if state.uncond_context is not None else None
        state = eng.admit(state, 0, toks,
                          torch.Generator(device=eng.device).manual_seed(0),
                          uncond_tokens=un)
        state = eng.slot_step(state)
        k = 1
        while k <= self.num_slots:
            eng.decode_slots(state, list(range(k))).cpu()
            k *= 2
        return time.perf_counter() - t0

    def run(self, requests: list, ledger: bool = False) -> dict:
        eng = self.engine
        if self.bank is None:
            for r in requests:
                if r.policy_index != 0:
                    raise ValueError(
                        f"request {r.rid} carries policy_index="
                        f"{r.policy_index} but the scheduler has no bank — "
                        f"pass bank= to ContinuousScheduler")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        ready: list = []
        owner: dict = {}
        state = eng.init_slots(self.num_slots, bank=self.bank)
        completed = 0
        steps = 0
        step_wall = 0.0
        occupancy_rows = 0
        t0 = time.perf_counter()
        while completed < len(requests):
            now = time.perf_counter() - t0
            poll_arrivals(pending, ready, now)
            free = [s for s in range(self.num_slots) if s not in owner]
            for slot in free:
                if not ready:
                    break
                req = ready.pop(0)
                state = eng.admit(state, slot, req.tokens, None,
                                  uncond_tokens=req.uncond_tokens,
                                  latents=req.latents,
                                  policy_index=req.policy_index)
                owner[slot] = req
                req.admitted_s = time.perf_counter() - t0
            if not owner:
                # nothing in flight: sleep to the next arrival
                if pending:
                    time.sleep(max(pending[0].arrival_s - now, 0.0))
                continue
            state = eng.slot_step(state)
            steps += 1
            step_wall += eng.last_wall_s
            occupancy_rows += len(owner)
            done = eng.finished_slots(state)
            if done:
                # one copy to the host per retirement decode
                images = eng.decode_slots(state, done).cpu().numpy()
                now = time.perf_counter() - t0
                for j, slot in enumerate(done):
                    req = owner.pop(slot)
                    req.finished_s = now
                    req.image = images[j]
                    completed += 1
                state = eng.retire(state, done)
        makespan = time.perf_counter() - t0
        cfg = eng.cfg
        metrics = {
            "mode": "continuous",
            "denoiser_family": eng.denoiser.family,
            "num_slots": self.num_slots,
            "engine_steps": steps,
            "step_wall_s": step_wall,
            "iter_wall_ms": 1e3 * step_wall / max(steps, 1),
            "mean_occupancy": occupancy_rows / max(steps * self.num_slots,
                                                   1),
            **_latency_metrics(requests, makespan, bank=self.bank,
                               default_steps=cfg.ddim.num_inference_steps),
        }
        if self.bank is not None:
            metrics["bank"] = [p.describe() for p in self.bank]
        if ledger and self.bank is not None:
            metrics["energy"] = energy_report_banked(
                cfg, state.accum, self.bank).summary()
            metrics["phase_breakdown"] = phase_breakdown_from_accum(
                cfg, state.accum, self.bank)
        elif ledger:
            rep = energy_report_from_accum(cfg, state.accum)
            metrics["energy"] = {k: float(v)
                                 for k, v in rep.summary().items()}
            ratios = tips_ratios_from_accum(cfg, state.accum)
            metrics["tips_low_ratio_per_iter"] = [float(r) for r in ratios]
            metrics["tips_workload_low_fraction"] = float(
                tips.workload_low_precision_fraction(ratios, ddim=cfg.ddim))
            # realized temporal-reuse ratio per iteration (zeros when off)
            metrics["reuse_ratio_per_iter"] = [
                float(r) for r in reuse_ratios_from_accum(cfg, state.accum)]
        metrics["state"] = state
        return metrics


class FixedBatchScheduler:
    """Micro-batching baseline under the same arrival gating.

    Packs admissible requests into fixed-size batches in arrival order; a
    batch launches when full or, once no arrival is due, as a padded
    partial (``stats_rows`` masks the padding out of the ledger, as
    ``serve_diffusion.serve`` does).  Every request of a batch finishes
    when the batch's whole generation does.
    """

    def __init__(self, engine, micro_batch: int):
        self.engine = engine
        self.micro_batch = micro_batch

    def warmup(self) -> float:
        eng = self.engine
        use_cfg = eng.cfg.ddim.guidance_scale != 1.0
        t0 = time.perf_counter()
        eng.warmup(self.micro_batch, use_cfg)
        return time.perf_counter() - t0

    def run(self, requests: list, ledger: bool = False) -> dict:
        eng = self.engine
        if any(r.policy_index != 0 for r in requests):
            raise ValueError(
                "FixedBatchScheduler cannot serve mixed quality tiers: a "
                "micro-batch shares one schedule, so rows cannot carry "
                "different solvers or step budgets — use "
                "ContinuousScheduler(bank=...) for tiered traces")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        ready: list = []
        stats_per_batch = []
        calls = 0
        call_wall = 0.0
        t0 = time.perf_counter()
        completed = 0
        while completed < len(requests):
            now = time.perf_counter() - t0
            poll_arrivals(pending, ready, now)
            if len(ready) < self.micro_batch and pending:
                # wait for a full batch while more arrivals are due
                time.sleep(max(pending[0].arrival_s - now, 0.0))
                continue
            if not ready:
                break
            batch = [ready.pop(0)
                     for _ in range(min(self.micro_batch, len(ready)))]
            valid = len(batch)

            def pack(rows):
                chunk, v = micro_batches(torch.cat(rows, dim=0),
                                         self.micro_batch)[0]
                assert v == valid, (v, valid)
                return chunk

            toks = pack([r.tokens for r in batch])
            lats = pack([r.latents for r in batch])
            uncond = (pack([r.uncond_tokens for r in batch])
                      if batch[0].uncond_tokens is not None else None)
            admit_t = time.perf_counter() - t0
            out = eng.generate(toks, None, uncond_tokens=uncond,
                               latents=lats,
                               stats_rows=valid if valid < self.micro_batch
                               else None)
            calls += 1
            call_wall += eng.last_wall_s
            images = out.images.cpu().numpy()
            fin = time.perf_counter() - t0
            for i, req in enumerate(batch):
                req.admitted_s = admit_t
                req.finished_s = fin
                req.image = images[i]
                completed += 1
            stats_per_batch.append(out.stats)
        makespan = time.perf_counter() - t0
        metrics = {
            "mode": "fixed_micro_batch",
            "denoiser_family": eng.denoiser.family,
            "micro_batch": self.micro_batch,
            "engine_calls": calls,
            "call_wall_s": call_wall,
            **_latency_metrics(requests, makespan),
        }
        if ledger and stats_per_batch:
            cfg = eng.cfg
            rep = energy_report_multi(cfg, stats_per_batch)
            metrics["energy"] = {k: float(v)
                                 for k, v in rep.summary().items()}
            ratios = aggregated_tips_ratios_per_iter(cfg, stats_per_batch)
            metrics["tips_low_ratio_per_iter"] = [float(r) for r in ratios]
            metrics["tips_workload_low_fraction"] = float(
                tips.workload_low_precision_fraction(ratios, ddim=cfg.ddim))
        return metrics
