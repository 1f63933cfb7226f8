"""Decoder stack for the ``ssm`` family (port of part of
``repro.models.transformer``).

Parameters keep the JAX package's layout: every layer leaf is stacked with
a leading L axis, so weights carry across one to one.  ``lax.scan`` over
that axis becomes a Python loop; there is no remat (no training yet).
The dense, moe and hybrid families raise ``NotImplementedError``: they are
still to be ported (ROADMAP.md, Queue 1 item 14).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_ssm(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"repro_torch runs only the 'ssm' family so far, not "
            f"{cfg.family!r} ({cfg.name}); see ROADMAP.md, Queue 1 item 14")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    """Per-layer trees -> one tree with a leading L axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------
def init_layer_params(generator: torch.Generator, cfg: ArchConfig, dtype):
    _require_ssm(cfg)
    d = cfg.d_model
    return {"ln1": torch.ones((d,), dtype=dtype, device=generator.device),
            "ssm": SSM.init_ssm_params(generator, cfg, dtype)}


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters from ``generator``, on its device, with the JAX
    package's shapes, scales and stacking."""
    _require_ssm(cfg)
    dtype = _dtype(cfg)
    dev = generator.device
    d, v = cfg.d_model, cfg.vocab_size
    emb = (torch.randn((v, d), generator=generator, device=dev)
           * 0.02).to(dtype)
    unemb = (torch.randn((d, v), generator=generator, device=dev)
             * d ** -0.5).to(dtype)
    layers = _stack([init_layer_params(generator, cfg, dtype)
                     for _ in range(cfg.num_layers)])
    return {"embed": emb, "unembed": unemb,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "layers": layers}


# ----------------------------------------------------------------------------
# Forward (prefill)
# ----------------------------------------------------------------------------
def _block_train(x, lp, cfg: ArchConfig, collect_cache: bool = False):
    """One layer, full-sequence.  Returns (x, cache_entry)."""
    xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if collect_cache:
        h, cache = SSM.mamba_mixer(xa, lp["ssm"], cfg, return_cache=True)
    else:
        h, cache = SSM.mamba_mixer(xa, lp["ssm"], cfg), None
    return x + h, cache


def forward(params, cfg: ArchConfig, tokens=None, embeds=None,
            collect_cache: bool = False, last_logit_only: bool = False):
    """-> (logits float32, cache-or-None); the cache is stacked over
    layers like the parameters.  The ssm family has no auxiliary loss, so
    the JAX package's ``aux`` output is left out."""
    _require_ssm(cfg)
    x = L.embed(tokens, params["embed"]) if embeds is None else embeds
    caches = []
    for i in range(cfg.num_layers):
        x, cache = _block_train(x, _layer(params["layers"], i), cfg,
                                collect_cache=collect_cache)
        caches.append(cache)
    if last_logit_only:
        x = x[:, -1:, :]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, params["unembed"])
    return logits, (_stack(caches) if collect_cache else None)


# ----------------------------------------------------------------------------
# Decode (serving)
# ----------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """Zeroed decode cache, stacked over layers.  ``max_seq`` is unused by
    the ssm family (its cache does not grow)."""
    _require_ssm(cfg)
    one = SSM.init_ssm_cache(cfg, batch, _dtype(cfg), device)
    return {k: torch.zeros((cfg.num_layers,) + tuple(a.shape),
                           dtype=a.dtype, device=a.device)
            for k, a in one.items()}


def decode_step(params, cache, tokens, position, cfg: ArchConfig):
    """One decode step.  tokens: (B, 1) integer; ``position`` is unused by
    the ssm family.  Returns (logits (B, 1, V) float32, new_cache)."""
    _require_ssm(cfg)
    x = L.embed(tokens, params["embed"])
    new = []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h, nc = SSM.mamba_decode(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                 _layer(cache, i), lp["ssm"], cfg)
        x = x + h
        new.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, params["unembed"])
    return logits, _stack(new)


def prefill(params, cfg: ArchConfig, tokens=None, embeds=None):
    """Prefill: last-token logits + the populated per-layer cache."""
    logits, cache = forward(params, cfg, tokens=tokens, embeds=embeds,
                               collect_cache=True, last_logit_only=True)
    return logits, cache
