"""Text-to-image serving front-end over the DiffusionEngine (port of
``repro.launch.serve_diffusion``).

  PYTHONPATH=src python -m repro_torch.launch.serve_diffusion --smoke \\
      --requests 8 --micro-batch 4 --steps 5 [--guidance 7.5] \\
      [--model unet|dit] [--kernels fused] [--tips adaptive] [--ledger] \\
      [--continuous --slots 4 --arrival-rate 2.0 --burst 2] \\
      [--replicas 2 --slots 2 [--slo-steps 8 --no-degrade] \\
       [--preview-every 5]] \\
      [--solver dpm2m,steps=12] [--tiers draft balanced quality] \\
      [--mesh 2] [--device cpu]

Runs on the card unless ``--device cpu`` is given (a host without CUDA
raises otherwise).  The policy flags (``--kernels``/``--tips``/
``--reuse``/``--solver``/``--tiers``) are the shared ``launch.cli``
wiring: one parse into a ``core.policies.ServePolicies`` bundle.
``--model`` picks the denoiser family: the BK-SDM UNet (default) or
DiT-S/2; ``--smoke`` the reduced geometry (full widths without it).
``--kernels`` selects the per-op kernel routing (``KernelPolicy``):
``reference``, ``fused``, ``autotuned`` (``fused`` with the launch knobs of
the committed autotune table, ``kernels.autotune``), or per-op overrides
like ``self_attention=fused,ffn=dbsc,ffn_quant=int8``.

Micro-batching (the default): prompts are packed into fixed-size
micro-batches (the tail padded with repeats and masked out of the ledger
by ``stats_rows``), each served by one ``generate`` with CFG fused into
one batched denoiser call per step.

Continuous batching (``--continuous``, DESIGN.md §8): a ``--slots``-row
batch stays in flight, every step advances all occupied slots, and
finished rows are decoded and swapped for queued prompts between steps.
``--arrival-rate`` (requests/s, ``--burst`` at a time; 0 = all at once)
drives a bursty trace, and the report adds enqueue-to-image latency
percentiles, queueing delay, occupancy and goodput.  ``--edit`` serves the
img2img request class (one base latent, a re-noised window per request);
``--tiers`` a mixed quality-tier bank inside one slot step.  The
``--ledger`` headline comes from the integer accumulator and equals the
same requests served one-shot.

Cluster routing (``--replicas N``, DESIGN.md §13): N slot states of
``--slots`` rows each behind one admission queue
(``launch.router.ClusterRouter``), FIFO into the least-occupied replica.
``--slo-steps`` sets a deadline in router rounds, under which an overdue
request degrades to a cheaper ``--tiers`` entry (``--no-degrade``:
queues instead); ``--preview-every K`` streams preview decodes of
in-flight rows.  The ``--ledger`` headline merges the replicas' integer
accumulators and is the same at any replica count.

Mesh mode (``--mesh N``, DESIGN.md §6): data-parallel micro-batches over
N ranks of one process group (``launch.mesh``), one process a rank: N
cards (NCCL; fewer cards raise ``make_data_mesh``'s message), or with
``--device cpu`` N gloo ranks on the host, the counterpart of the JAX
package's simulated host devices.  The micro-batch is rounded up to a
multiple of N; every rank serves the same queue, each generating its
rows, and the first rank's report is printed.  The ledger is built from
the global stats, so it is the unsharded run's.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import tips
from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.diffusion.pipeline import (aggregated_reuse_ratios_per_iter,
                                            aggregated_tips_ratios_per_iter,
                                            energy_report_multi)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.cli import (add_policy_args, config_from_args,
                                    policies_from_args)
from repro_torch.launch.router import ClusterRouter, RouterSLO
from repro_torch.launch.scheduler import (ContinuousScheduler, apply_trace,
                                          bursty_trace, make_edit_requests,
                                          make_requests, micro_batches,
                                          request_generator)


MESH_SERVE_TIMEOUT_S = 3600.0   # --mesh: the spawned group's whole run


def make_config(args, policies=None):
    """Config for a CLI namespace (the shared ``launch.cli`` wiring), with
    ``policies`` installed (``None``: parsed from ``args``)."""
    return config_from_args(args, policies=policies)


def synthetic_requests(cfg, n: int, seed: int = 7, device=None
                       ) -> torch.Tensor:
    """n prompt token rows drawn from a CPU generator seeded ``seed``, on
    ``device`` (``None``: the card).  No tokenizer offline; the prompts'
    meaning does not matter."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.text.vocab_size, (n, cfg.text.max_len),
                         generator=g, dtype=torch.int32)
    return toks.to(resolve_device(device))


def serve(cfg, requests, micro_batch: int, seed: int = 0,
          ledger: bool = False, sampler_policy=None, device=None,
          mesh=None) -> dict:
    """Drain the request rows through the engine in micro-batches; return
    serving metrics.

    The engine's weights come from a generator seeded ``seed`` on
    ``device`` (``None``: the card), batch ``i``'s initial latents from
    ``scheduler.request_generator(seed, i)``.  ``sampler_policy`` (a
    ``solvers.SamplerPolicy``) applies to every request; the ledger then
    normalizes by its step budget.  ``mesh`` (a ``launch.mesh`` mesh; run
    this on each of its ranks) serves data-parallel: the micro-batch is
    rounded up to a multiple of its dp size, and every rank returns the
    same global metrics but its own times.
    """
    device = resolve_device(device)
    eng = DiffusionEngine(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed), mesh=mesh)
    dp = eng.dp_size
    # micro-batches must tile evenly over the data axis
    micro_batch = -(-micro_batch // dp) * dp
    use_cfg = cfg.ddim.guidance_scale != 1.0
    uncond = (torch.zeros((micro_batch, cfg.text.max_len), dtype=torch.int32,
                          device=device) if use_cfg else None)

    # run exactly the shapes the loop will run once first: the full batch
    # (skipped when every request fits one padded tail) and the tail's
    # stats_rows one
    n_requests = int(requests.shape[0])
    tail = n_requests % micro_batch
    compile_s = 0.0
    if n_requests >= micro_batch:
        compile_s += eng.warmup(micro_batch, use_cfg,
                                sampler_policy=sampler_policy)
    if tail:
        compile_s += eng.warmup(micro_batch, use_cfg, stats_rows=tail,
                                sampler_policy=sampler_policy)
    batches = micro_batches(requests, micro_batch)
    s, c = cfg.unet.latent_size, cfg.unet.in_channels

    images = 0
    padded = 0
    wall = 0.0
    stats_per_batch = []
    for i, (toks, valid) in enumerate(batches):
        lat = torch.randn((micro_batch, s, s, c),
                          generator=request_generator(seed, i))
        out = eng.generate(toks, uncond_tokens=uncond,
                           latents=lat.to(device),
                           stats_rows=valid if valid < micro_batch else None,
                           sampler_policy=sampler_policy)
        wall += eng.last_wall_s
        images += valid
        padded += micro_batch - valid
        stats_per_batch.append(out.stats)

    steps = (cfg.ddim.num_inference_steps if sampler_policy is None
             else sampler_policy.num_steps)
    metrics = {
        "requests": n_requests,
        "denoiser_family": eng.denoiser.family,
        "kernel_policy": cfg.unet.kernel_policy.describe(device),
        "precision_policy": cfg.unet.precision.describe(),
        "micro_batch": micro_batch,
        "mesh": None if mesh is None else {
            "dp": dp,
            "shape": mesh_mod.mesh_shape(mesh),
            "devices": int(mesh.size()),
        },
        "engine_calls": len(batches),
        "padded_rows": padded,
        "steps_per_image": steps,
        "guidance_fused_cfg": use_cfg,
        "compile_s": compile_s,
        "serve_wall_s": wall,
        "imgs_per_s": images / max(wall, 1e-9),
        "iter_wall_ms": 1e3 * wall / max(len(batches) * steps, 1),
    }
    if sampler_policy is not None:
        metrics["sampler_policy"] = sampler_policy.describe()
    if ledger and stats_per_batch:
        rep = energy_report_multi(cfg, stats_per_batch,
                                  sampler_policy=sampler_policy)
        metrics["energy"] = {k: float(v) for k, v in rep.summary().items()}
        if steps == cfg.ddim.num_inference_steps:
            # the per-iteration extras index the config's schedule; a
            # policy with its own budget reports through the summary
            ratios = aggregated_tips_ratios_per_iter(cfg, stats_per_batch)
            metrics["tips_low_ratio_per_iter"] = [float(r) for r in ratios]
            metrics["tips_workload_low_fraction"] = float(
                tips.workload_low_precision_fraction(ratios, ddim=cfg.ddim))
            metrics["reuse_ratio_per_iter"] = [
                float(r) for r in
                aggregated_reuse_ratios_per_iter(cfg, stats_per_batch)]
    return metrics


def serve_continuous(cfg, num_requests: int, num_slots: int,
                     arrival_rate: float = 0.0, burst: int = 1,
                     ledger: bool = False, seed: int = 7, edit: bool = False,
                     bank=None, device=None) -> dict:
    """Serve a synthetic request trace through the continuous scheduler.

    ``arrival_rate`` is requests/s, ``burst`` at a time (0 = the whole
    queue at t = 0).  The warm-up runs off the clock, so the latency
    percentiles measure serving.  ``edit`` serves the img2img request
    class (``scheduler.make_edit_requests``); ``bank`` (tuple of
    ``solvers.SamplerPolicy``) mixed tiers, round-robin, with the banked
    ledger.  The engine's weights come from the default generator (seed
    0) on ``device`` (``None``: the card), the requests from ``seed``.
    """
    device = resolve_device(device)
    eng = DiffusionEngine(cfg, device=device)
    if edit:
        requests = make_edit_requests(cfg, num_requests, seed=seed,
                                      device=device)
    else:
        requests = make_requests(cfg, num_requests, seed=seed, bank=bank,
                                 device=device)
    if arrival_rate > 0:
        gap = burst / arrival_rate
        apply_trace(requests, bursty_trace(num_requests, burst, gap))
    sched = ContinuousScheduler(eng, num_slots, bank=bank)
    compile_s = sched.warmup()
    metrics = sched.run(requests, ledger=ledger)
    metrics.pop("state")
    metrics.update(
        compile_s=compile_s,
        kernel_policy=cfg.unet.kernel_policy.describe(device),
        precision_policy=cfg.unet.precision.describe(),
        reuse_policy=cfg.unet.reuse_policy.describe(),
        steps_per_image=(cfg.ddim.num_inference_steps if bank is None
                         else [p.num_steps for p in bank]),
        workload="edit" if edit else "t2i",
        arrival={"rate_per_s": arrival_rate, "burst": burst},
    )
    return metrics


def serve_cluster(cfg, num_requests: int, replicas: int, num_slots: int,
                  arrival_rate: float = 0.0, burst: int = 1,
                  ledger: bool = False, seed: int = 7, bank=None,
                  slo_steps: int = 0, degrade: bool = True,
                  preview_every: int = 0, device=None) -> dict:
    """Serve a synthetic trace through the multi-replica cluster router.

    ``replicas`` slot states of ``num_slots`` rows share one engine
    (``launch.router.ClusterRouter``); ``slo_steps`` (> 0) turns on
    round-denominated SLO admission: under overload a request degrades to
    a lower bank tier instead of queueing (``degrade=False``: the
    queueing baseline).  ``preview_every`` streams preview decodes of
    in-flight rows.  The ``ledger`` headline merges every replica's
    integer accumulator (``pipeline.energy_report_cluster``) and is the
    same at any replica count.  The engine's weights come from the
    default generator (seed 0) on ``device`` (``None``: the card), the
    requests from ``seed``.
    """
    device = resolve_device(device)
    eng = DiffusionEngine(cfg, device=device)
    router = ClusterRouter(eng, replicas, num_slots, bank=bank,
                           slo=RouterSLO(deadline_steps=slo_steps or None,
                                         degrade=degrade),
                           preview_every=preview_every)
    requests = make_requests(cfg, num_requests, seed=seed, bank=router.bank,
                             device=device)
    if arrival_rate > 0:
        gap = burst / arrival_rate
        apply_trace(requests, bursty_trace(num_requests, burst, gap))
    compile_s = router.warmup()
    metrics = router.run(requests, ledger=ledger)
    metrics.pop("states")
    metrics.update(
        compile_s=compile_s,
        kernel_policy=cfg.unet.kernel_policy.describe(device),
        precision_policy=cfg.unet.precision.describe(),
        reuse_policy=cfg.unet.reuse_policy.describe(),
        steps_per_image=(cfg.ddim.num_inference_steps if router.bank is None
                         else [p.num_steps for p in router.bank]),
        workload="t2i",
        arrival={"rate_per_s": arrival_rate, "burst": burst},
    )
    return metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry (CPU-friendly)")
    add_policy_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--micro-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5,
                    help="DDIM iterations (paper: 25)")
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--ledger", action="store_true",
                    help="print the full-geometry energy headline")
    ap.add_argument("--edit", action="store_true",
                    help="serve the img2img/editing request class (shared "
                         "base latent + localized per-request edits); "
                         "pair with --continuous and --reuse temporal")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching instead of fixed "
                         "micro-batches (DESIGN.md §8)")
    ap.add_argument("--slots", type=int, default=4,
                    help="in-flight slot count for --continuous")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="request arrivals per second for --continuous "
                         "(0 = whole queue available at t=0)")
    ap.add_argument("--burst", type=int, default=1,
                    help="arrivals per burst for --arrival-rate")
    ap.add_argument("--replicas", type=int, default=0,
                    help="cluster-router mode (DESIGN.md §13): run N "
                         "slot-state replicas behind occupancy routing "
                         "(0 = single scheduler); uses --slots per replica")
    ap.add_argument("--slo-steps", type=int, default=0,
                    help="router SLO: enqueue->image deadline in router "
                         "rounds; under overload requests degrade to a "
                         "lower --tiers entry instead of queueing "
                         "(0 = no SLO)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="queue instead of degrading when the SLO cannot "
                         "be met (the positive-control baseline)")
    ap.add_argument("--preview-every", type=int, default=0,
                    help="router streaming: decode progressive previews "
                         "of in-flight rows every K rounds (0 = off)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel degree: shard micro-batches over N "
                         "ranks (N cards, or N CPU ranks with --device "
                         "cpu); 0 = single-device")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; a "
                         "host without CUDA raises unless 'cpu' is given)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.micro_batch < 1:
        ap.error("--micro-batch must be >= 1")
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.mesh < 0:
        ap.error("--mesh must be >= 0")
    if args.slots < 1:
        ap.error("--slots must be >= 1")
    if args.burst < 1:
        ap.error("--burst must be >= 1")
    if args.arrival_rate < 0:
        ap.error("--arrival-rate must be >= 0")
    if args.continuous and args.mesh > 1:
        ap.error("--continuous is single-device (see DESIGN.md §8); "
                 "drop --mesh")
    if args.edit and not args.continuous:
        ap.error("--edit rides the slot scheduler's admit(latents=) path; "
                 "add --continuous")
    if args.tiers and not (args.continuous or args.replicas):
        ap.error("--tiers is mixed-tier serving over the slot engine; "
                 "add --continuous or --replicas (micro-batches share one "
                 "schedule — use --solver for a single policy)")
    if args.replicas < 0:
        ap.error("--replicas must be >= 0")
    if args.replicas:
        if args.mesh > 1:
            ap.error("--replicas runs the single-device slot runtime per "
                     "replica (DESIGN.md §13); drop --mesh")
        if args.edit:
            ap.error("--replicas serves t2i traces; --edit rides the "
                     "single-replica --continuous path")
        if args.continuous:
            ap.error("--replicas IS continuous batching across N slot "
                     "states; drop --continuous")
    if args.slo_steps and not args.replicas:
        ap.error("--slo-steps is cluster-router admission; add --replicas")
    if args.slo_steps and not args.no_degrade and not args.tiers:
        ap.error("SLO degradation picks lower tiers from a bank; add "
                 "--tiers (or --no-degrade for the queueing baseline)")
    if args.preview_every and not args.replicas:
        ap.error("--preview-every is cluster-router streaming; add "
                 "--replicas")
    if args.tiers and args.solver:
        ap.error("--tiers and --solver are exclusive: a bank already "
                 "names every policy in flight")
    if args.tiers and args.edit:
        ap.error("--edit traces share one base latent workload; tiered "
                 "admission is t2i-only for now")

    device = resolve_device(args.device)
    if args.mesh > 1:
        mesh_mod.require_devices(args.mesh, device)
    # one parse of the policy surface feeds the config and the bank
    policies = policies_from_args(args)
    cfg = make_config(args, policies=policies)
    sampler_policy = policies.sampler
    bank = policies.bank
    sampling = ("tiers " + "+".join(p.label() for p in bank) if bank
                else sampler_policy.key() if sampler_policy
                else f"ddim@{args.steps}")
    batching = (f"router replicas={args.replicas} slots={args.slots}"
                if args.replicas
                else f"continuous slots={args.slots}" if args.continuous
                else f"micro-batch {args.micro_batch}")
    print(f"engine: model {args.model}, latent {cfg.unet.latent_size}^2, "
          f"sampling {sampling}, guidance {args.guidance} "
          f"({'fused-CFG' if args.guidance != 1.0 else 'no CFG'}), "
          f"{batching}, kernels {args.kernels}, tips {args.tips}, "
          f"reuse {args.reuse}, workload {'edit' if args.edit else 't2i'}, "
          f"device {device}, "
          f"mesh {'dp=' + str(args.mesh) if args.mesh > 1 else 'none'}")
    if bank is None and sampler_policy is not None and (
            args.replicas or args.continuous):
        bank = (sampler_policy,)          # single-tier bank
    if args.replicas:
        metrics = serve_cluster(cfg, args.requests, args.replicas,
                                args.slots, arrival_rate=args.arrival_rate,
                                burst=args.burst, ledger=args.ledger,
                                bank=bank, slo_steps=args.slo_steps,
                                degrade=not args.no_degrade,
                                preview_every=args.preview_every,
                                device=device)
    elif args.continuous:
        metrics = serve_continuous(cfg, args.requests, args.slots,
                                   arrival_rate=args.arrival_rate,
                                   burst=args.burst, ledger=args.ledger,
                                   edit=args.edit, bank=bank, device=device)
    elif args.mesh > 1:
        metrics = mesh_mod.spawn(
            _serve_on_mesh, args.mesh,
            args=(cfg, args.requests, args.micro_batch, args.ledger,
                  sampler_policy, args.mesh),
            device=device, timeout=MESH_SERVE_TIMEOUT_S)[0]
    else:
        reqs = synthetic_requests(cfg, args.requests, device=device)
        metrics = serve(cfg, reqs, args.micro_batch, ledger=args.ledger,
                        sampler_policy=sampler_policy, device=device)
    print(json.dumps(metrics, indent=2))
    return metrics


def _serve_on_mesh(cfg, n_requests: int, micro_batch: int, ledger: bool,
                   sampler_policy, dp: int) -> dict:
    """One rank of ``--mesh``: the whole synthetic queue through ``serve``
    on a (dp, 1) data mesh of the spawned group."""
    device = mesh_mod.group_device()
    reqs = synthetic_requests(cfg, n_requests, device=device)
    return serve(cfg, reqs, micro_batch, ledger=ledger,
                 sampler_policy=sampler_policy, device=device,
                 mesh=mesh_mod.make_data_mesh(dp))


if __name__ == "__main__":
    main()
