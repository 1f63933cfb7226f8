"""Shared CLI wiring for the serving-policy surface (port of
``repro.launch.cli``; DESIGN.md §13).

* :func:`add_policy_args` registers ``--model --kernels --tips --reuse
  --solver --tiers`` on an ``ArgumentParser``;
* :func:`policies_from_args` turns the parsed namespace into one
  ``core.policies.ServePolicies`` bundle (with the serving reuse-capacity
  clamp);
* :func:`config_from_args` builds the ``PipelineConfig`` (geometry,
  denoiser family, schedule) with the bundle's policies installed.

``--kernels auto`` (the default) resolves for the namespace's ``device``
(``None``: the card): ``fused`` there, ``reference`` on the CPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.policies import ServePolicies
from repro_torch.diffusion.dit import DiTConfig
from repro_torch.diffusion.pipeline import PipelineConfig
from repro_torch.diffusion.sampler import DDIMConfig


def add_policy_args(ap, tiers: bool = True):
    """Register the shared policy flags on ``ap``; ``tiers=False`` leaves
    out ``--tiers`` (a CLI of one request has no bank).  Returns ``ap``."""
    ap.add_argument("--model", choices=("unet", "dit"), default="unet",
                    help="denoiser family (DESIGN.md §11): the BK-SDM "
                         "UNet (default) or the DiT-S/2 transformer, both "
                         "through the same engine, scheduler and kernel "
                         "dispatch table")
    ap.add_argument("--kernels", default="auto",
                    help="kernel policy: 'auto' (fused on the card, "
                         "reference on the CPU), 'reference', 'fused', "
                         "'autotuned' (fused with the committed autotune "
                         "table's launch knobs), or per-op overrides like "
                         "'self_attention=fused,cross_attention=fused,"
                         "ffn=dbsc,ffn_quant=int8' (see "
                         "repro_torch.kernels.dispatch.KernelPolicy)")
    ap.add_argument("--tips", default="fixed",
                    help="precision policy: 'fixed', 'adaptive', or field "
                         "overrides like 'adaptive,target=0.5,mid=true' "
                         "(see repro_torch.core.precision.PrecisionPolicy)")
    ap.add_argument("--reuse", default="off",
                    help="temporal patch-reuse policy: 'off', 'temporal', "
                         "or overrides like 'temporal,threshold=0.1' "
                         "(see repro_torch.core.reuse.ReusePolicy)")
    ap.add_argument("--solver", default="",
                    help="sampler policy for EVERY request: a tier name "
                         "('draft'|'balanced'|'quality'), a solver "
                         "('ddim'|'plms'|'dpm2m'), or overrides like "
                         "'dpm2m,steps=10,phases=detail_guard' (see "
                         "repro_torch.diffusion.solvers.SamplerPolicy); "
                         "empty = the config's DDIM schedule")
    if tiers:
        ap.add_argument("--tiers", nargs="+", default=None,
                        help="mixed quality-tier serving bank: one "
                             "SamplerPolicy spec per tier (e.g. --tiers "
                             "draft balanced quality); requests cycle "
                             "through the tiers round-robin inside one "
                             "slot step")
    return ap


def policies_from_args(args) -> ServePolicies:
    """Parsed namespace -> one frozen ``ServePolicies`` bundle.

    Serving runs the temporal reuse path (the cache starts invalid),
    where a gather capacity under 1.0 is refused, so ``--reuse edit,...``
    keeps its threshold and serves at capacity 1.0.
    """
    pol = ServePolicies.parse(kernels=getattr(args, "kernels", "auto"),
                              tips=getattr(args, "tips", "fixed"),
                              reuse=getattr(args, "reuse", "off"),
                              solver=getattr(args, "solver", ""),
                              tiers=getattr(args, "tiers", None),
                              device=getattr(args, "device", None))
    if pol.reuse.enabled and pol.reuse.capacity < 1.0:
        pol = dataclasses.replace(
            pol, reuse=dataclasses.replace(pol.reuse, capacity=1.0))
    return pol


def config_from_args(args, policies=None, steps=None):
    """The ``PipelineConfig`` a CLI run serves.

    Geometry from ``--smoke`` (absent from the namespace: smoke),
    denoiser family from ``--model``, schedule from ``--steps`` (the
    ``steps`` keyword, where given, takes its place) and ``--guidance``,
    TIPS active for the first ``steps * 20 // 25`` iterations (at least
    one), and the bundle's policies installed (``policies=None``: parsed
    from ``args``).
    """
    smoke = getattr(args, "smoke", True)
    cfg = PipelineConfig.smoke() if smoke else PipelineConfig()
    if getattr(args, "model", "unet") == "dit":
        dit = DiTConfig()
        cfg = dataclasses.replace(cfg, unet=dit.smoke() if smoke else dit)
    if steps is None:
        steps = getattr(args, "steps", 5)
    guidance = getattr(args, "guidance", 1.0)
    cfg = dataclasses.replace(
        cfg,
        ddim=DDIMConfig(num_inference_steps=steps,
                        guidance_scale=guidance,
                        tips_active_iters=max(1, steps * 20 // 25)))
    if policies is None:
        policies = policies_from_args(args)
    return policies.apply(cfg)
