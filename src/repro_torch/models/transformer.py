"""Decoder stack for every LM family: dense, moe, ssm and hybrid (port of
``repro.models.transformer``).

Parameters keep the JAX package's layout: every layer leaf is stacked with
a leading L axis, so weights carry across one to one.  ``lax.scan`` over
that axis becomes a Python loop, and the per-layer global flag of the
hybrid family a Python bool.  ``forward`` returns the moe family's
load-balance loss summed over the layers (``aux``), and with ``remat``
recomputes each layer in the backward pass (JAX's save-nothing
``jax.checkpoint``); ``loss_fn`` is the training objective.

Paper features: PSSA (post-softmax score pruning in self-attention,
``cfg.pssa``) and TIPS (sink-token CAS -> per-token INT12/INT6 FFN
precision, ``cfg.tips``).  ``cfg.dbsc`` drives nothing here, as in the JAX
transformer.

Decode caches: stacked {"k", "v"} (int8 under ``kv_cache_dtype="int8"``)
for dense and moe, stacked {"state", "conv"} for ssm, and for hybrid a
list of per-layer {"k", "v", "ssm"} whose SWA layers hold ring buffers of
``min(sliding_window, max_seq)`` slots.  ``decode_step`` writes the new
key and value into its cache in place.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _is_global_layer(cfg: ArchConfig, i: int) -> bool:
    if not cfg.sliding_window:
        return True
    return i in (0, cfg.num_layers // 2, cfg.num_layers - 1)


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


def _empty_stacked(tree, n: int):
    """An uninitialised tree shaped like ``tree`` with a leading n axis."""
    if isinstance(tree, dict):
        return {k: _empty_stacked(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _assign(stacked, i: int, tree) -> None:
    """Write one layer's tree into slice ``i`` of a stacked tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _assign(stacked[k], i, v)
    else:
        stacked[i].copy_(tree)


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------
def init_layer_params(generator: torch.Generator, cfg: ArchConfig, dtype):
    d = cfg.d_model
    dev = generator.device

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)
    p = {"ln1": ones()}
    if cfg.family in ("dense", "moe", "hybrid"):
        p.update(L.init_attn_params(generator, cfg, dtype))
        p["ln2"] = ones()
    if cfg.family == "dense":
        p.update(L.init_ffn_params(generator, d, cfg.d_ff,
                                   cfg.ffn_activation, dtype))
    elif cfg.family == "moe":
        p["moe"] = MOE.init_moe_params(generator, cfg, dtype)
    elif cfg.family == "ssm":
        p["ssm"] = SSM.init_ssm_params(generator, cfg, dtype)
    elif cfg.family == "hybrid":
        p["ssm"] = SSM.init_ssm_params(generator, cfg, dtype)
        p["attn_norm"] = ones()
        p["ssm_norm"] = ones()
        p.update(L.init_ffn_params(generator, d, cfg.d_ff,
                                   cfg.ffn_activation, dtype))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters from ``generator``, on its device, with the JAX
    package's shapes, scales and stacking.

    Each stacked leaf is allocated once and filled layer by layer, so the
    peak is the model plus one layer, not the model twice (qwen2-moe is
    28.6 GB in bfloat16)."""
    dtype = _dtype(cfg)
    dev = generator.device
    d, v = cfg.d_model, cfg.vocab_size
    emb = (torch.randn((v, d), generator=generator, device=dev)
           * 0.02).to(dtype)
    unemb = (torch.randn((d, v), generator=generator, device=dev)
             * d ** -0.5).to(dtype)
    layer = init_layer_params(generator, cfg, dtype)
    layers = _empty_stacked(layer, cfg.num_layers)
    _assign(layers, 0, layer)
    for i in range(1, cfg.num_layers):
        layer = init_layer_params(generator, cfg, dtype)
        _assign(layers, i, layer)
    del layer
    return {"embed": emb, "unembed": unemb,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "layers": layers}


# ----------------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------------
def _block_train(x, lp, cfg: ArchConfig, positions, is_global=None,
                 collect_cache: bool = False):
    """One layer, full-sequence.  Returns (x, aux_loss float32 scalar,
    cache_entry); aux is the moe family's load-balance loss, 0 for the
    other families."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    prune = cfg.pssa_threshold if cfg.pssa else 0.0

    if cfg.family == "ssm":
        xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if collect_cache:
            h, cache = SSM.mamba_mixer(xa, lp["ssm"], cfg, return_cache=True)
        else:
            h = SSM.mamba_mixer(xa, lp["ssm"], cfg)
        return x + h, aux, cache

    xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        attn_out, sink, kv = L.gqa_attention(xa, lp, cfg, positions,
                                             window=cfg.sliding_window,
                                             prune_threshold=prune,
                                             global_flag=is_global)
        if collect_cache:
            ssm_out, ssm_cache = SSM.mamba_mixer(xa, lp["ssm"], cfg,
                                                 return_cache=True)
            cache = {"k": kv[0], "v": kv[1], "ssm": ssm_cache}
        else:
            ssm_out = SSM.mamba_mixer(xa, lp["ssm"], cfg)
        attn_out = L.rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps)
        ssm_out = L.rms_norm(ssm_out, lp["ssm_norm"], cfg.norm_eps)
        h = 0.5 * (attn_out + ssm_out)
    else:
        h, sink, kv = L.gqa_attention(xa, lp, cfg, positions,
                                      prune_threshold=prune)
        if collect_cache:
            cache = {"k": kv[0], "v": kv[1]}
    x = x + h

    tips_mask = sink < cfg.tips_threshold if cfg.tips else None
    xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = MOE.moe_ffn(xf, lp["moe"], cfg, tips_important=tips_mask)
    else:
        f = L.ffn(xf, lp, cfg.ffn_activation, tips_important=tips_mask)
    return x + f.to(x.dtype), aux, cache


# ----------------------------------------------------------------------------
# Forward (train / prefill)
# ----------------------------------------------------------------------------
def forward(params, cfg: ArchConfig, tokens=None, embeds=None,
            remat: bool = True, collect_cache: bool = False,
            last_logit_only: bool = False):
    """-> (logits float32, aux, cache-or-None).

    ``aux`` is the float32 sum over layers of the moe load-balance loss
    (0 for the other families); the cache is stacked over layers like the
    parameters.  ``remat`` wraps each layer in a non-reentrant
    ``torch.utils.checkpoint``: nothing inside a layer is saved for the
    backward pass, which recomputes it (the JAX package's save-nothing
    ``jax.checkpoint``).  It changes no value, and where autograd records
    nothing it is skipped.  ``cfg.remat_save_collectives`` names the
    tensor-parallel all-reduce outputs to keep; with no mesh there is none
    (it comes with multi-GPU training), so it is ignored here.
    """
    x = L.embed(tokens, params["embed"]) if embeds is None else embeds
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    wrap = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.num_layers):
        ig = _is_global_layer(cfg, i) if cfg.sliding_window else None
        lp = _layer(params["layers"], i)
        if wrap:
            x, a, cache = torch.utils.checkpoint.checkpoint(
                _block_train, x, lp, cfg, positions, ig, collect_cache,
                use_reentrant=False)
        else:
            x, a, cache = _block_train(x, lp, cfg, positions, is_global=ig,
                                       collect_cache=collect_cache)
        aux = aux + a
        caches.append(cache)
    if last_logit_only:
        x = x[:, -1:, :]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, params["unembed"])
    return logits, aux, (_stack(caches) if collect_cache else None)


def loss_fn(params, batch, cfg: ArchConfig, aux_coef: float = 0.01,
            remat: bool = True):
    """Next-token cross-entropy: -> (nll + aux_coef * aux, {"nll", "aux"}).

    ``batch`` holds ``labels`` (B, T) and ``tokens`` (B, T) or ``embeds``
    (B, T, d).  The nll is the mean of logsumexp minus the gold logit over
    the float32 logits."""
    logits, aux, _ = forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), remat=remat)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    return nll + aux_coef * aux, {"nll": nll, "aux": aux}


# ----------------------------------------------------------------------------
# Decode (serving): KV/SSM caches, one-token step
# ----------------------------------------------------------------------------
def _kv_zeros(shape, dtype, device):
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """Zeroed decode cache for ``max_seq`` positions (unused by the ssm
    family, whose cache does not grow)."""
    dtype = _dtype(cfg)
    lcount = cfg.num_layers
    if cfg.family == "ssm":
        one = SSM.init_ssm_cache(cfg, batch, dtype, device)
        return {k: torch.zeros((lcount,) + tuple(a.shape), dtype=a.dtype,
                               device=a.device)
                for k, a in one.items()}
    kvshape = (cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "hybrid":
        caches = []
        for i in range(lcount):
            s = max_seq if _is_global_layer(cfg, i) else min(
                cfg.sliding_window, max_seq)
            c = _kv_zeros((batch, s) + kvshape, dtype, device)
            c["ssm"] = SSM.init_ssm_cache(cfg, batch, dtype, device)
            caches.append(c)
        return caches
    # dense / moe: uniform stacked KV, int8 on request
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    return _kv_zeros((lcount, batch, max_seq) + kvshape, kv_dtype, device)


def decode_cache_from_prefill(cfg: ArchConfig, pcache, max_seq: int):
    """The decode cache for ``max_seq`` positions, holding what
    ``prefill`` of T <= max_seq tokens left in ``pcache``.

    * dense / moe: the prefill KV in positions [0, T), through
      ``_kv_store`` (int8 under ``kv_cache_dtype="int8"``);
    * ssm: the prefill cache itself;
    * hybrid: each layer's entry of ``init_cache``'s list.  A global layer
      takes the prefill KV in positions [0, T); an SWA layer of W slots
      takes the last min(W, T) positions p at slot p % W, where
      ``decode_attention_slot`` reads them; the SSM state and conv tail
      pass as they are.  (The JAX launcher decodes hybrid requests from a
      zeroed cache instead: ROADMAP.md, Queue 3 item 18.)
    """
    if cfg.family == "ssm":
        return pcache
    batch, t = pcache["k"].shape[1:3]
    if t > max_seq:
        raise ValueError(f"prefill of {t} tokens does not fit a decode cache "
                         f"of {max_seq} positions")
    cache = init_cache(cfg, batch, max_seq, pcache["k"].device)
    if cfg.family in ("dense", "moe"):
        for k in ("k", "v"):
            cache[k][:, :, :t] = L._kv_store(pcache[k], cache[k].dtype)
        return cache
    for i, c in enumerate(cache):
        w = c["k"].shape[1]
        if _is_global_layer(cfg, i):
            src, dst = slice(0, t), slice(0, t)
        else:
            m = min(w, t)
            src = slice(t - m, t)
            dst = torch.arange(t - m, t, device=c["k"].device) % w
        for k in ("k", "v"):
            c[k][:, dst] = pcache[k][i][:, src].to(c[k].dtype)
        c["ssm"] = {"state": pcache["ssm"]["state"][i],
                    "conv": pcache["ssm"]["conv"][i]}
    return cache


def decode_step(params, cache, tokens, position: int, cfg: ArchConfig):
    """One decode step.  tokens: (B, 1) integer; ``position``: the
    position of ``tokens`` (unused by the ssm family).  Returns (logits
    (B, 1, V) float32, new_cache); KV caches are updated in place."""
    x = L.embed(tokens, params["embed"])

    if cfg.family == "ssm":
        new = []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h, nc = SSM.mamba_decode(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                     _layer(cache, i), lp["ssm"], cfg)
            x = x + h
            new.append(nc)
        new_cache = _stack(new)
    elif cfg.family == "hybrid":
        new_cache = []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            c = cache[i]
            xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            win = c["k"].shape[1]
            is_g = _is_global_layer(cfg, i)
            # ring-buffer slot on SWA layers, linear slot on global ones
            slot = position if is_g else position % win
            attn_out, ck, cv, sink = L.decode_attention_slot(
                xa, lp, cfg, c["k"], c["v"], position, slot,
                window=0 if is_g else win)
            ssm_out, nssm = SSM.mamba_decode(xa, c["ssm"], lp["ssm"], cfg)
            attn_out = L.rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps)
            ssm_out = L.rms_norm(ssm_out, lp["ssm_norm"], cfg.norm_eps)
            x = x + 0.5 * (attn_out + ssm_out)
            tips_mask = (sink < cfg.tips_threshold) if cfg.tips else None
            xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.ffn(xf, lp, cfg.ffn_activation,
                          tips_important=tips_mask)
            new_cache.append({"k": ck, "v": cv, "ssm": nssm})
    else:
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            attn_out, _, _, sink = L.decode_attention(
                xa, lp, cfg, cache["k"][i], cache["v"][i], position)
            x = x + attn_out
            tips_mask = (sink < cfg.tips_threshold) if cfg.tips else None
            xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                f, _ = MOE.moe_ffn(xf, lp["moe"], cfg,
                                   tips_important=tips_mask)
            else:
                f = L.ffn(xf, lp, cfg.ffn_activation,
                          tips_important=tips_mask)
            x = x + f
        new_cache = cache

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, params["unembed"])
    return logits, new_cache


def prefill(params, cfg: ArchConfig, tokens=None, embeds=None):
    """Prefill: last-token logits + the populated per-layer cache."""
    logits, _, cache = forward(params, cfg, tokens=tokens, embeds=embeds,
                               remat=False, collect_cache=True,
                               last_logit_only=True)
    return logits, cache
