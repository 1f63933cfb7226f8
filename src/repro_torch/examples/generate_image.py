"""End-to-end text-to-image generation, the paper's Fig. 1(a) flow (port of
``examples/generate_image.py``).

Text encode -> DDIM UNet iterations (PSSA pruning and TIPS mixed precision
live) -> VAE decode, then the measured compression and precision
statistics feed the full BK-SDM-Tiny ledger and the Table-I-style energy
summary is printed.

On the card it runs BK-SDM-Tiny at full width (``--smoke``: the reduced
geometry the JAX example runs on its CPU).  ``--kernels`` defaults to the
main path's route, the three hand-written kernels: PSSA self-attention,
TIPS cross-attention and the DBSC bit-slice FFN (the JAX example's default
``auto`` is fused attention with the float FFN; pass ``--kernels auto`` for
it).  The default path is ``DiffusionEngine``; ``--python-loop`` runs the
per-step ``StableDiffusionPipeline``.  Both feed the same ledger.

Run:  PYTHONPATH=src python -m repro_torch.examples.generate_image
          [--steps 5] [--model unet|dit] [--solver dpm2m,steps=12]
          [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                            energy_report)
from repro_torch.diffusion.solvers import TIERS
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.cli import (add_policy_args, config_from_args,
                                    policies_from_args)

MAIN_PATH_KERNELS = "self_attention=fused,cross_attention=fused,ffn=dbsc"
DEFAULT_OUT = os.path.join(tempfile.gettempdir(),
                           "repro_torch_generated_image.npy")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5,
                    help="DDIM iterations (paper: 25; the JAX example's "
                         "CPU demo default 5)")
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--python-loop", action="store_true",
                    help="per-step StableDiffusionPipeline instead of the "
                         "engine")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry (full width without it)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the uint8 image goes (.npy)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; 'cpu' runs "
                         "the kernels' plain versions)")
    # the policy surface (--model/--kernels/--tips/--reuse/--solver) is
    # the same wiring serve_diffusion and the cluster router register
    add_policy_args(ap, tiers=False)
    ap.set_defaults(kernels=MAIN_PATH_KERNELS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.solver and args.python_loop:
        ap.error("--solver needs the engine (the per-step pipeline has no "
                 "SamplerPolicy runtime)")
    policies = policies_from_args(args)
    policy = policies.sampler
    if policy is not None and "steps=" not in args.solver \
            and args.solver not in TIERS:
        policy = dataclasses.replace(policy, num_steps=args.steps)
    cfg = config_from_args(args, policies=policies)
    n_steps = policy.num_steps if policy is not None else args.steps
    sampler_desc = (f"{policy.solver} x{policy.num_steps}"
                    + (" (phased)" if policy.phases else "")
                    if policy is not None else f"ddim x{args.steps}")
    print(f"pipeline: model {args.model}, latent {cfg.unet.latent_size}^2, "
          f"sampler {sampler_desc}, guidance {args.guidance}, "
          f"{'python loop' if args.python_loop else 'engine'}, "
          f"kernels {args.kernels}, tips {args.tips}")

    # "a toy raccoon standing on a pile of broccoli": the tokens are
    # synthetic (no tokenizer offline); the energy evaluation does not
    # depend on their meaning
    prompt = torch.randint(0, cfg.text.vocab_size, (1, cfg.text.max_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(7), device=dev)
    uncond = torch.zeros_like(prompt) if args.guidance != 1.0 else None

    weights = torch.Generator(device=dev).manual_seed(0)
    noise = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    if args.python_loop:
        pipe = StableDiffusionPipeline(cfg, device=dev, generator=weights)
        image, stats = pipe.generate(prompt, noise, uncond_tokens=uncond)
    else:
        eng = DiffusionEngine(cfg, device=dev, generator=weights)
        out = eng.generate(prompt, noise, uncond_tokens=uncond,
                           sampler_policy=policy)
        image, stats = out.images, out.stats
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    print(f"generated image {tuple(image.shape)} in {wall:.1f}s "
          f"({1e3 * wall / n_steps:.0f} ms/iter incl. weights), "
          f"range [{float(image.min()):.2f}, {float(image.max()):.2f}]")
    img8 = ((image[0] * 0.5 + 0.5) * 255).clamp(0, 255).to(torch.uint8)
    np.save(args.out, img8.cpu().numpy())
    print(f"saved {args.out}")

    rep = energy_report(cfg, stats, sampler_policy=policy)
    geometry = "BK-SDM-Tiny" if args.model == "unet" else "DiT-S/2"
    print(f"\nfull-geometry ({geometry}, family={args.model}) "
          f"energy ledger:")
    summary = rep.summary()
    for k, v in summary.items():
        print(f"  {k:42s} {v:10.4f}")
    if policy is not None:
        print(f"  {'mj_per_image (x' + str(n_steps) + ' steps)':42s} "
              f"{rep.mj_per_iter_with_ema * n_steps:10.4f}")
    return {"summary": summary, "image_shape": tuple(image.shape),
            "finite": bool(torch.isfinite(image).all()), "wall_s": wall,
            "latent_size": cfg.unet.latent_size}


if __name__ == "__main__":
    main()
