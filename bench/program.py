"""The system under test, built as the serving CLI builds it: the port's
preset configuration named by the configuration file, checked size for
size against the file, its DDIM schedule set from the file, the kernel,
precision and reuse policies parsed from the file's specs, one
``DiffusionEngine`` on the benchmark's weights and one
``ClusterRouter`` replica of ``slots`` rows over it
(``serve_diffusion --replicas 1 --slots S``)."""
from __future__ import annotations

import dataclasses
import importlib

SECTIONS = ("text", "unet", "vae")


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return list(a) == list(b)
    return a == b


def check_sizes(cfg, model: dict) -> None:
    """Every size of the file equals the preset's: the program runs what
    the file says."""
    for section in SECTIONS:
        have = getattr(cfg, section)
        for key, want in model[section].items():
            if not _same(getattr(have, key), want):
                raise ValueError(f"{section}.{key}: the program's preset has "
                                 f"{getattr(have, key)!r}, the file {want!r}")
    if cfg.unet.pssa_threshold != model["features"]["pssa_threshold"]:
        raise ValueError("features.pssa_threshold differs from the preset")


def build(model: dict, mix: dict, weights: dict, device):
    from repro_torch.core.policies import ServePolicies
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.sampler import DDIMConfig
    from repro_torch.launch.router import ClusterRouter

    prog = model["program"]
    cfg = getattr(importlib.import_module(prog["module"]), prog["attr"])
    check_sizes(cfg, model)
    cfg = dataclasses.replace(cfg, ddim=DDIMConfig(**model["ddim"]))
    tiers = None if mix["tiers"] == ["config"] else list(mix["tiers"])
    pol = ServePolicies.parse(kernels=prog["kernels"], tips=prog["tips"],
                              reuse=prog["reuse"], tiers=tiers,
                              device=str(device))
    feat = model["features"]
    if (pol.precision.threshold != feat["tips_threshold"]
            or pol.precision.cls_index != feat["cls_index"]
            or pol.precision.spotting != "fixed" or pol.precision.ffn_mid):
        raise ValueError(f"the tips spec {prog['tips']!r} is not the "
                         f"file's fixed spotting at {feat['tips_threshold']}")
    engine = DiffusionEngine(cfg, device=device, params=weights,
                             policies=pol)
    router = ClusterRouter(engine, replicas=1,
                           slots_per_replica=mix["slots"])
    return engine, router


def make_requests(plan: dict, inputs: list, bank_tiers, device) -> list:
    """The program's request objects for the planned arrivals."""
    import torch
    from repro_torch.launch.scheduler import Request

    out = []
    for i, ((toks, lat), arrival, tier) in enumerate(
            zip(inputs, plan["arrivals"], plan["tiers"])):
        out.append(Request(
            rid=i, tokens=toks.to(device), arrival_s=float(arrival),
            latents=lat.to(device),
            uncond_tokens=torch.zeros_like(toks).to(device),
            policy_index=0 if bank_tiers is None else bank_tiers.index(tier),
            tier=tier))
    return out
