"""Cluster router: N slot-state replicas behind one admission queue (port
of ``repro.launch.router``; DESIGN.md §13).

  PYTHONPATH=src python -m repro_torch.launch.router --replicas 2 \\
      --slots 2 --requests 8 --steps 5 [--check-identity] [--device cpu]

One ``ContinuousScheduler`` fills a single slot batch; serving real
traffic takes many.  A ``SlotState`` holds all mutable serving state (the
engine holds only parameters), so N replicas are N independent
``SlotState``s stepped through ONE engine: no parameter copies, and a
request's image does not depend on the replica that served it.  On one
card the replicas' steps run one after another.

What the router adds over the single-replica scheduler:

* **Occupancy routing** — each admissible request (FIFO) enters the
  least-occupied replica with a free slot.
* **SLO-aware admission: degrade, don't queue** — with a
  ``RouterSLO(deadline_steps=...)`` and a sampler bank, a request whose
  queue wait has eaten its deadline is admitted at a LOWER tier of the
  bank (the largest step budget that still meets the deadline, else the
  bank's cheapest tier) instead of waiting for its own.  Deadlines count
  ROUNDS (one round = one ``slot_step`` of every occupied replica), so the
  decisions are the same on any machine.
* **Decode off the hot loop** — retirement and preview decodes are
  queued on the device between steps and copied to the host only after
  the next admission pass, so pixel movement never holds up admission.
* **Streaming** — ``stream()`` yields per-request ``admitted`` /
  ``preview`` / ``finished`` events; previews decode in-flight latents
  every ``preview_every`` rounds.

Ledger contract: every replica scatters integer counters into the same
``LedgerAccum`` bucket layout, and ``pipeline.merge_ledger_accums`` /
``energy_report_cluster`` sum them before reporting, so the energy
headline is the same at any replica count, routing decision and
admission order, and (degradation aside) equal to the same requests
served one-shot.  The images are the same across replica counts wherever
rows do not share a quantizer scale: on the float FFN (the DBSC FFN
quantizes the whole batch on one scale, ROADMAP.md Queue 3 item 13).

Time base: ``t_s``, ``admitted_s``, ``finished_s`` and
``first_preview_s`` are host ``perf_counter`` seconds from the start of
``stream``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import torch

from repro_torch.diffusion import solvers
from repro_torch.diffusion.pipeline import energy_report_cluster
from repro_torch.launch.scheduler import (_lat_summary, _latency_metrics,
                                          poll_arrivals)


@dataclasses.dataclass(frozen=True)
class RouterSLO:
    """Round-denominated latency SLO for cluster admission.

    ``deadline_steps``: the enqueue-to-image budget in router rounds (a
    round advances every occupied replica by one denoising iteration).
    ``degrade=True`` serves a cheaper tier now rather than the requested
    tier late; ``degrade=False`` is the queueing baseline.
    """
    deadline_steps: Optional[int] = None
    degrade: bool = True

    def met(self, req) -> Optional[bool]:
        """Did ``req`` finish within its round budget? (None: no SLO.)"""
        if self.deadline_steps is None or req.finish_round is None:
            return None
        return (req.finish_round - req.arrival_round) <= self.deadline_steps


class ClusterRouter:
    """Route requests across ``replicas`` slot-state replicas of
    ``slots_per_replica`` rows each.

    ``engine`` is shared: replica ``i`` is an independent ``SlotState``
    stepped through it.  ``engines`` (one per replica, e.g. each on its
    own card) supplies the replicas' engines instead; they must share
    ``engine``'s pipeline config, so images and ledger buckets agree.

    ``bank`` defaults to ``engine.policies.bank``, as in the
    single-replica scheduler.  ``preview_every=K`` (> 0) decodes a preview
    of every in-flight row each K rounds and streams it as a ``preview``
    event.
    """

    def __init__(self, engine, replicas: int, slots_per_replica: int,
                 bank=None, slo: Optional[RouterSLO] = None,
                 preview_every: int = 0, engines=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if engines is not None:
            engines = list(engines)
            if len(engines) != replicas:
                raise ValueError(
                    f"engines= carries {len(engines)} engines for "
                    f"{replicas} replicas")
            for e in engines:
                if e.cfg != engine.cfg:
                    raise ValueError(
                        "per-replica engines must share the pipeline "
                        "config — differing configs fork executables, "
                        "images and ledger buckets")
        self.engine = engine
        self.engines = engines or [engine] * replicas
        self.replicas = replicas
        self.slots_per_replica = slots_per_replica
        if bank is None:
            bank = engine.policies.bank
        self.bank = solvers.as_bank(bank) if bank is not None else None
        self.slo = slo or RouterSLO()
        if (self.slo.deadline_steps is not None and self.slo.degrade
                and self.bank is None):
            raise ValueError(
                "RouterSLO degradation needs a sampler bank — the lower "
                "tiers a request can degrade to must be compiled into the "
                "step executable (pass bank= or build the engine with "
                "ServePolicies(bank=...))")
        self.preview_every = preview_every

    # -- lifecycle -------------------------------------------------------
    def warmup(self) -> float:
        """One admit, one step and every power-of-two decode a run can
        hit, off the clock, once for each distinct engine (replicas that
        share one warm it once).  Returns the wall seconds."""
        t0 = time.perf_counter()
        for eng in dict.fromkeys(self.engines):        # unique, in order
            state = eng.init_slots(self.slots_per_replica, bank=self.bank)
            toks = torch.zeros((1, eng.cfg.text.max_len), dtype=torch.int32,
                               device=eng.device)
            un = toks if state.uncond_context is not None else None
            state = eng.admit(state, 0, toks, torch.Generator(
                device=eng.device).manual_seed(0), uncond_tokens=un)
            state = eng.slot_step(state)
            k = 1
            while k <= self.slots_per_replica:
                eng.decode_slots(state, list(range(k))).cpu()
                k *= 2
        return time.perf_counter() - t0

    # -- SLO admission ---------------------------------------------------
    def _admission_tier(self, req, round_idx: int) -> int:
        """Bank index to admit ``req`` at, degrading if its wait demands.

        With ``waited`` rounds spent queueing, a tier meets the deadline
        only if ``waited + num_steps <= deadline_steps``.  When the
        requested tier cannot, take the LARGEST-budget strictly-lower tier
        that can; when none can, the bank's cheapest tier (best effort).
        Never upgrades.
        """
        pidx = req.policy_index
        slo = self.slo
        if (slo.deadline_steps is None or not slo.degrade
                or self.bank is None):
            return pidx
        waited = round_idx - req.arrival_round
        steps = self.bank[pidx].num_steps
        if waited + steps <= slo.deadline_steps:
            return pidx
        fitting = [i for i, p in enumerate(self.bank)
                   if p.num_steps < steps
                   and waited + p.num_steps <= slo.deadline_steps]
        if fitting:
            return max(fitting, key=lambda i: (self.bank[i].num_steps, -i))
        cheapest = min(range(len(self.bank)),
                       key=lambda i: (self.bank[i].num_steps, i))
        return cheapest if self.bank[cheapest].num_steps < steps else pidx

    # -- serving ---------------------------------------------------------
    def stream(self, requests: list) -> Iterator[dict]:
        """Serve ``requests``, yielding progress events as they happen.

        Events are dicts with ``event`` in ``{"admitted", "preview",
        "finished"}`` plus ``rid`` / ``replica`` / ``round`` / ``t_s``
        (``admitted`` also ``slot``, ``tier`` and ``degraded_from``);
        ``preview`` events carry the decoded in-flight ``image`` and the
        row's ``step``, ``finished`` events the final ``image`` (also
        stored on the request).  Returns once every request has finished:
        the router never drops a request.
        """
        if self.bank is None:
            for r in requests:
                if r.policy_index != 0:
                    raise ValueError(
                        f"request {r.rid} carries policy_index="
                        f"{r.policy_index} but the router has no bank")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        ready: list = []
        owners = [dict() for _ in range(self.replicas)]
        engines = self.engines
        states = [eng.init_slots(self.slots_per_replica, bank=self.bank)
                  for eng in engines]
        decode_jobs: list = []    # (req, round, image row on the device)
        preview_jobs: list = []   # (req, step, image row on the device)
        completed = 0
        round_idx = 0
        stepped_rows = 0
        step_calls = 0
        step_wall = 0.0
        self._t0 = t0 = time.perf_counter()
        while completed < len(requests) or decode_jobs or preview_jobs:
            now = time.perf_counter() - t0
            poll_arrivals(pending, ready, now)
            for r in ready:
                if r.arrival_round is None:
                    r.arrival_round = round_idx
            # FIFO admission into the least-occupied replica; the degrade
            # decision is made here, with the request's realized wait
            while ready:
                free = [(len(owners[i]), i) for i in range(self.replicas)
                        if len(owners[i]) < self.slots_per_replica]
                if not free:
                    break
                req = ready.pop(0)
                _, ri = min(free)
                slot = next(s for s in range(self.slots_per_replica)
                            if s not in owners[ri])
                pidx = self._admission_tier(req, round_idx)
                if pidx != req.policy_index:
                    req.degraded_from = req.tier
                    req.policy_index = pidx
                    req.tier = self.bank[pidx].label()
                states[ri] = engines[ri].admit(
                    states[ri], slot, req.tokens, None,
                    uncond_tokens=req.uncond_tokens, latents=req.latents,
                    policy_index=req.policy_index)
                owners[ri][slot] = req
                req.replica = ri
                req.admitted_s = time.perf_counter() - t0
                yield {"event": "admitted", "rid": req.rid, "replica": ri,
                       "slot": slot, "round": round_idx,
                       "tier": req.tier, "degraded_from": req.degraded_from,
                       "t_s": req.admitted_s}
            # copy the decodes queued LAST round to the host: the device
            # ran them while the admissions above were queued
            for req, fin_round, row in decode_jobs:
                req.image = row.cpu().numpy()[0]
                req.finished_s = time.perf_counter() - t0
                req.finish_round = fin_round
                completed += 1
                yield {"event": "finished", "rid": req.rid,
                       "replica": req.replica, "round": fin_round,
                       "tier": req.tier, "image": req.image,
                       "t_s": req.finished_s}
            decode_jobs = []
            for req, at_step, row in preview_jobs:
                img = row.cpu().numpy()[0]
                req.previews += 1
                pv_t = time.perf_counter() - t0
                if req.first_preview_s is None:
                    req.first_preview_s = pv_t
                yield {"event": "preview", "rid": req.rid,
                       "replica": req.replica, "round": round_idx,
                       "step": at_step, "image": img, "t_s": pv_t}
            preview_jobs = []
            if not any(owners):
                if completed < len(requests) and pending:
                    time.sleep(max(pending[0].arrival_s
                                   - (time.perf_counter() - t0), 0.0))
                continue
            # one router round: step every occupied replica
            for ri in range(self.replicas):
                if not owners[ri]:
                    continue
                states[ri] = engines[ri].slot_step(states[ri])
                step_calls += 1
                step_wall += engines[ri].last_wall_s
                stepped_rows += len(owners[ri])
            round_idx += 1
            # every host read of the round (finished rows; the preview
            # rows' steps) comes before any decode is queued, so none waits
            # for a decode: slot_step has synchronised
            preview = bool(self.preview_every
                           and round_idx % self.preview_every == 0)
            done = [[s for s in engines[ri].finished_slots(states[ri])
                     if s in owners[ri]] if owners[ri] else []
                    for ri in range(self.replicas)]
            step_of = [states[ri].step_idx.tolist()
                       if preview and len(owners[ri]) > len(done[ri])
                       else None for ri in range(self.replicas)]
            # queue the retirement decodes and free the slots NOW: the
            # rows are admissible next pass, the pixels copied after it
            for ri in range(self.replicas):
                if done[ri]:
                    imgs = engines[ri].decode_slots(states[ri], done[ri])
                    for j, slot in enumerate(done[ri]):
                        decode_jobs.append((owners[ri].pop(slot),
                                            round_idx, imgs[j:j + 1]))
                    states[ri] = engines[ri].retire(states[ri], done[ri])
            # previews of the rows still in flight
            for ri in range(self.replicas):
                slots = sorted(owners[ri])
                if step_of[ri] is None or not slots:
                    continue
                pv = engines[ri].decode_preview(states[ri], slots)
                for j, slot in enumerate(slots):
                    preview_jobs.append((owners[ri][slot],
                                         step_of[ri][slot], pv[j:j + 1]))
        self._states = states
        self._rounds = round_idx
        self._step_calls = step_calls
        self._step_wall = step_wall
        self._stepped_rows = stepped_rows

    def run(self, requests: list, ledger: bool = False) -> dict:
        """Drain :meth:`stream` and return serving metrics.

        ``ledger=True`` adds the merged-replica energy report
        (``pipeline.energy_report_cluster``), the same at any replica
        count.  ``metrics["states"]`` carries the per-replica
        ``SlotState``s (callers pop it before serializing).
        """
        events = {"admitted": 0, "preview": 0, "finished": 0}
        for ev in self.stream(requests):
            events[ev["event"]] += 1
        makespan = time.perf_counter() - self._t0
        states = self._states
        cfg = self.engine.cfg
        metrics = {
            "mode": "cluster_router",
            "denoiser_family": self.engine.denoiser.family,
            "replicas": self.replicas,
            "slots_per_replica": self.slots_per_replica,
            "rounds": self._rounds,
            "engine_steps": self._step_calls,
            "step_wall_s": self._step_wall,
            "mean_occupancy": self._stepped_rows / max(
                self._step_calls * self.slots_per_replica, 1),
            "events": events,
            "dropped": len(requests) - events["finished"],
            "policies": self.engine.policies.describe(self.engine.device),
            **_latency_metrics(requests, makespan, bank=self.bank,
                               default_steps=cfg.ddim.num_inference_steps),
        }
        if self.slo.deadline_steps is not None:
            met = [bool(self.slo.met(r)) for r in requests]
            metrics["slo"] = {
                "deadline_steps": self.slo.deadline_steps,
                "degrade": self.slo.degrade,
                "met": sum(met),
                "attainment": sum(met) / max(len(met), 1),
            }
        if self.preview_every:
            firsts = [r.first_preview_s for r in requests
                      if r.first_preview_s is not None]
            metrics["preview"] = {
                "every": self.preview_every,
                "decodes": events["preview"],
                "first_preview_s": _summary_or_none(firsts),
            }
        if ledger:
            rep = energy_report_cluster(cfg, [st.accum for st in states],
                                        bank=self.bank)
            # a banked summary carries per-policy lists; the unbanked
            # summary is all scalars
            metrics["energy"] = (rep.summary() if self.bank is not None
                                 else {k: float(v)
                                       for k, v in rep.summary().items()})
        metrics["states"] = states
        return metrics


def _summary_or_none(vals):
    return _lat_summary(vals) if vals else None


def _main(argv=None) -> int:
    """Router smoke entry point.

    ``--check-identity`` serves the same trace at 1 replica and at
    ``--replicas`` and raises unless the merged energy headline and every
    image are bit-identical and no request was dropped (DESIGN.md §13).
    Runs on the card unless ``--device cpu`` is given.
    """
    import argparse
    import json

    import numpy as np

    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch.cli import (add_policy_args, config_from_args,
                                        policies_from_args)
    from repro_torch.launch.scheduler import (apply_trace, bursty_trace,
                                              make_requests)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_policy_args(ap)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2,
                    help="slots per replica")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--burst", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--slo-steps", type=int, default=0,
                    help="deadline in router rounds (0: no SLO)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="queue instead of degrading under overload")
    ap.add_argument("--preview-every", type=int, default=0)
    ap.add_argument("--check-identity", action="store_true",
                    help="assert ledger bit-identity 1 vs N replicas")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; a "
                         "host without CUDA raises unless 'cpu' is given)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    policies = policies_from_args(args)
    cfg = config_from_args(args, policies=policies, steps=args.steps)
    eng = DiffusionEngine(cfg, device=device, policies=policies)
    slo = RouterSLO(deadline_steps=args.slo_steps or None,
                    degrade=not args.no_degrade)

    def serve(replicas):
        router = ClusterRouter(eng, replicas, args.slots,
                               slo=slo if replicas == args.replicas
                               else RouterSLO(),
                               preview_every=args.preview_every)
        reqs = make_requests(cfg, args.requests, seed=7, bank=router.bank,
                             device=device)
        apply_trace(reqs, bursty_trace(args.requests, args.burst, 0.05))
        router.warmup()
        m = router.run(reqs, ledger=True)
        m.pop("states")
        return m, reqs

    out, reqs = serve(args.replicas)
    if args.check_identity:
        m1, reqs1 = serve(1)
        out["ledger_bit_identical_across_replicas"] = (
            out["energy"] == m1["energy"])
        out["images_bit_identical_across_replicas"] = all(
            np.array_equal(a.image, b.image) for a, b in zip(reqs, reqs1))
        if not out["ledger_bit_identical_across_replicas"]:
            raise RuntimeError(f"ledger differs across replica counts: "
                               f"{out['energy']} != {m1['energy']}")
        if not out["images_bit_identical_across_replicas"]:
            raise RuntimeError("images differ across replica counts")
        if out["dropped"] or m1["dropped"]:
            raise RuntimeError("dropped requests")
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
