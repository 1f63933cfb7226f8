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

On a (data, model) mesh (``ctx``, a ``layers.ShardCtx``) every entry point
takes this rank's rows of the batch and this rank's shard of the
parameters (``shard_params``: the layout ``param_layout`` gives, the
executed counterpart of the JAX package's ``param_specs``), and returns
full-vocabulary logits for its rows.  Attention, FFN, experts and Mamba
heads run split where they divide the model axis, else replicated; the
embeddings are vocab-parallel where the vocabulary divides it (the loss
then takes its logsumexp and gold logit across the shards without
gathering the logits), hidden-split where only ``d_model`` does.  The
loss and the moe aux are means over the data axes.  Over a model axis of
one rank every collective is an identity and the ops are those of
``ctx=None``: the result is the same bits.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.parallel import (
    P, Split, collective_tape, copy_to_tp, gather_from_tp, gather_tree,
    max_over_tp, mean_over_dp, reduce_from_tp, shard_tree, split_ctx,
    stack_layout)


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
def init_layer_params(generator: torch.Generator, cfg: ArchConfig, dtype,
                      device=None):
    d = cfg.d_model
    dev = generator.device if device is None else device

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)
    p = {"ln1": ones()}
    if cfg.family in ("dense", "moe", "hybrid"):
        p.update(L.init_attn_params(generator, cfg, dtype, dev))
        p["ln2"] = ones()
    if cfg.family == "dense":
        p.update(L.init_ffn_params(generator, d, cfg.d_ff,
                                   cfg.ffn_activation, dtype, dev))
    elif cfg.family == "moe":
        p["moe"] = MOE.init_moe_params(generator, cfg, dtype, dev)
    elif cfg.family == "ssm":
        p["ssm"] = SSM.init_ssm_params(generator, cfg, dtype, dev)
    elif cfg.family == "hybrid":
        p["ssm"] = SSM.init_ssm_params(generator, cfg, dtype, dev)
        p["attn_norm"] = ones()
        p["ssm_norm"] = ones()
        p.update(L.init_ffn_params(generator, d, cfg.d_ff,
                                   cfg.ffn_activation, dtype, dev))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device=None) -> dict:
    """Random parameters from ``generator``, on ``device`` (the
    generator's by default), with the JAX package's shapes, scales and
    stacking.

    Each stacked leaf is allocated once and filled layer by layer, so the
    peak is the model plus one layer, not the model twice (qwen2-moe is
    28.6 GB in bfloat16)."""
    dtype = _dtype(cfg)
    dev = generator.device if device is None else device
    d, v = cfg.d_model, cfg.vocab_size
    emb = (torch.randn((v, d), generator=generator, device=dev)
           * 0.02).to(dtype)
    unemb = (torch.randn((d, v), generator=generator, device=dev)
             * d ** -0.5).to(dtype)
    layer = init_layer_params(generator, cfg, dtype, dev)
    layers = _empty_stacked(layer, cfg.num_layers)
    _assign(layers, 0, layer)
    for i in range(1, cfg.num_layers):
        layer = init_layer_params(generator, cfg, dtype, dev)
        _assign(layers, i, layer)
    del layer
    return {"embed": emb, "unembed": unemb,
            "final_norm": torch.ones((d,), dtype=dtype, device=dev),
            "layers": layers}


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree's shapes and dtypes on the meta device, no
    storage allocated (JAX: ``jax.eval_shape`` of ``init_params``)."""
    return init_params(torch.Generator(), cfg, device="meta")


# ----------------------------------------------------------------------------
# Partition specs (the JAX package's trees) and the executed layout
# ----------------------------------------------------------------------------
def layer_param_specs(cfg: ArchConfig, tp_size: int):
    p = {"ln1": P(None)}
    if cfg.family in ("dense", "moe", "hybrid"):
        p.update(L.attn_param_specs(cfg))
        p["ln2"] = P(None)
    if cfg.family == "dense":
        p.update(L.ffn_param_specs(cfg.ffn_activation))
    elif cfg.family == "moe":
        p["moe"] = MOE.moe_param_specs(cfg, tp_size)
    elif cfg.family == "ssm":
        p["ssm"] = SSM.ssm_param_specs(cfg)
    elif cfg.family == "hybrid":
        p["ssm"] = SSM.ssm_param_specs(cfg)
        p["attn_norm"] = P(None)
        p["ssm_norm"] = P(None)
        p.update(L.ffn_param_specs(cfg.ffn_activation))
    return p


def param_specs(cfg: ArchConfig, tp_size: int):
    """The JAX package's PartitionSpec tree: layers stacked (a leading
    None); vocab-parallel embeddings where the vocabulary divides the
    model axis, else the hidden axis split."""
    lspecs = layer_param_specs(cfg, tp_size)

    def stacked(t):
        if isinstance(t, dict):
            return {k: stacked(v) for k, v in t.items()}
        return P(None, *t)
    if cfg.vocab_size % tp_size == 0:
        embed, unembed = P("model", None), P(None, "model")
    else:
        embed, unembed = P(None, "model"), P("model", None)
    return {"embed": embed, "unembed": unembed, "final_norm": P(None),
            "layers": stacked(lspecs)}


def cache_specs(cfg: ArchConfig, batch: int, dp_axes: tuple, tp_size: int):
    """The JAX package's PartitionSpecs for the decode cache."""
    bspec = dp_axes if batch >= 2 * tp_size else None
    if cfg.family == "ssm":
        # state (L, B, h, p, n): the JAX package splits p (64, always
        # divisible); the port splits heads (ssm.py's docstring)
        return {"state": P(None, bspec, None, "model", None),
                "conv": P(None, bspec, None, "model")}
    if cfg.num_kv_heads % tp_size == 0:
        kvspec = P(None, bspec, None, "model", None)
    elif bspec is None:
        # long-context single request: the sequence split everywhere
        kvspec = P(None, None, tuple(dp_axes) + ("model",), None, None)
    else:
        kvspec = P(None, bspec, "model", None, None)
    if cfg.family == "hybrid":
        per_layer = {
            "k": P(*kvspec[1:]), "v": P(*kvspec[1:]),
            "ssm": {"state": P(bspec, None, "model", None),
                    "conv": P(bspec, None, "model")},
        }
        return [per_layer] * cfg.num_layers
    return {"k": kvspec, "v": kvspec}


def _embed_mode(cfg: ArchConfig, tp: int):
    """"vocab" (vocab-parallel), "hidden" (d_model split) or None
    (replicated) for the embedding tables over ``tp`` ranks."""
    if tp == 1:
        return None
    if cfg.vocab_size % tp == 0:
        return "vocab"
    return "hidden" if cfg.d_model % tp == 0 else None


def layer_layout(cfg: ArchConfig, tp: int):
    """How one layer's leaves split over ``tp`` ranks (None: whole)."""
    p = {"ln1": None}
    if cfg.family in ("dense", "moe", "hybrid"):
        p.update(L.attn_layout(cfg, tp))
        p["ln2"] = None
    if cfg.family in ("dense", "hybrid"):
        p.update(L.ffn_layout(cfg.d_ff, cfg.ffn_activation, tp))
    if cfg.family == "moe":
        p["moe"] = MOE.moe_layout(cfg, tp)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = SSM.ssm_layout(cfg, tp)
    if cfg.family == "hybrid":
        p["attn_norm"] = p["ssm_norm"] = None
    return p


def param_layout(cfg: ArchConfig, tp: int):
    """The executed counterpart of ``param_specs``: each leaf's ``Split``
    over ``tp`` ranks, or None where it stays whole (everything at tp 1)."""
    mode = _embed_mode(cfg, tp)
    emb = {"vocab": (Split(0), Split(1)), "hidden": (Split(1), Split(0)),
           None: (None, None)}[mode]
    layers = stack_layout(layer_layout(cfg, tp)) if tp > 1 else None
    return {"embed": emb[0], "unembed": emb[1], "final_norm": None,
            "layers": layers}


def shard_params(params, cfg: ArchConfig, ctx):
    """This rank's shard of a full parameter tree (a view of it where
    nothing splits)."""
    if ctx is None:
        return params
    return shard_tree(params, param_layout(cfg, ctx.tp_size), ctx)


def gather_params(params, cfg: ArchConfig, ctx):
    """The full parameter tree from every rank's shard (a collective over
    the model axis)."""
    if ctx is None:
        return params
    return gather_tree(params, param_layout(cfg, ctx.tp_size), ctx)


# ----------------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------------
def _block_train(x, lp, cfg: ArchConfig, positions, is_global=None,
                 collect_cache: bool = False, ctx=None):
    """One layer, full-sequence.  Returns (x, aux_loss float32 scalar,
    cache_entry); aux is the moe family's load-balance loss, 0 for the
    other families."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    prune = cfg.pssa_threshold if cfg.pssa else 0.0

    if cfg.family == "ssm":
        xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if collect_cache:
            h, cache = SSM.mamba_mixer(xa, lp["ssm"], cfg, return_cache=True,
                                       ctx=ctx)
        else:
            h = SSM.mamba_mixer(xa, lp["ssm"], cfg, ctx=ctx)
        return x + h, aux, cache

    xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        attn_out, sink, kv = L.gqa_attention(xa, lp, cfg, positions,
                                             window=cfg.sliding_window,
                                             prune_threshold=prune,
                                             global_flag=is_global, ctx=ctx)
        if collect_cache:
            ssm_out, ssm_cache = SSM.mamba_mixer(xa, lp["ssm"], cfg,
                                                 return_cache=True, ctx=ctx)
            cache = {"k": kv[0], "v": kv[1], "ssm": ssm_cache}
        else:
            ssm_out = SSM.mamba_mixer(xa, lp["ssm"], cfg, ctx=ctx)
        attn_out = L.rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps)
        ssm_out = L.rms_norm(ssm_out, lp["ssm_norm"], cfg.norm_eps)
        h = 0.5 * (attn_out + ssm_out)
    else:
        h, sink, kv = L.gqa_attention(xa, lp, cfg, positions,
                                      prune_threshold=prune, ctx=ctx)
        if collect_cache:
            cache = {"k": kv[0], "v": kv[1]}
    x = x + h

    tips_mask = sink < cfg.tips_threshold if cfg.tips else None
    xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = MOE.moe_ffn(xf, lp["moe"], cfg, tips_important=tips_mask,
                             ctx=ctx)
    else:
        f = L.ffn(xf, lp, cfg.ffn_activation, tips_important=tips_mask,
                  ctx=split_ctx(ctx, L.ffn_layout, cfg.d_ff,
                                cfg.ffn_activation))
    return x + f.to(x.dtype), aux, cache


def _embed(tokens, table, cfg: ArchConfig, ctx):
    """Token embeddings, replicated over the model axis: vocab-parallel
    (this rank's rows looked up, the rest zeros, summed over the axis) or
    hidden-split (this rank's columns, gathered)."""
    mode = _embed_mode(cfg, ctx.tp_size) if ctx is not None else None
    if mode == "vocab":
        n = table.shape[0]
        local = tokens.long() - ctx.tp_rank * n
        mine = (local >= 0) & (local < n)
        x = table[torch.where(mine, local, 0)]
        return reduce_from_tp(torch.where(mine[..., None], x, 0), ctx)
    if mode == "hidden":
        return gather_from_tp(table[tokens], ctx, dim=-1)
    return L.embed(tokens, table)


def _unembed(x, table, cfg: ArchConfig, ctx):
    """-> (float32 logits, split): this rank's vocabulary columns where
    the embeddings are vocab-parallel (``split`` True), else every
    column."""
    mode = _embed_mode(cfg, ctx.tp_size) if ctx is not None else None
    if mode == "vocab":
        return L.unembed(copy_to_tp(x, ctx), table), True
    if mode == "hidden":
        n = table.shape[0]
        xs = copy_to_tp(x, ctx)[..., ctx.tp_rank * n:(ctx.tp_rank + 1) * n]
        return reduce_from_tp(L.unembed(xs, table), ctx), False
    return L.unembed(x, table), False


def _full_logits(logits, split: bool, ctx):
    return gather_from_tp(logits, ctx, dim=-1) if split else logits


def _nll(logits, labels, split: bool, ctx):
    """Mean of logsumexp minus the gold logit.  Vocab-split logits: the
    max, the sum of exponentials and the gold logit are reduced over the
    model axis, the logits never gathered."""
    labels = labels.long()
    if not split:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(logz - gold)
    n = logits.shape[-1]
    m = max_over_tp(logits.detach().amax(dim=-1), ctx)
    se = reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1), ctx)
    local = labels - ctx.tp_rank * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = reduce_from_tp(torch.where(mine, gold[..., 0], 0.0), ctx)
    return torch.mean(torch.log(se) + m - gold)


# ----------------------------------------------------------------------------
# Forward (train / prefill)
# ----------------------------------------------------------------------------
def forward(params, cfg: ArchConfig, tokens=None, embeds=None,
            remat: bool = True, collect_cache: bool = False,
            last_logit_only: bool = False, ctx=None):
    """-> (logits float32, aux, cache-or-None).

    ``aux`` is the float32 sum over layers of the moe load-balance loss
    (0 for the other families); the cache is stacked over layers like the
    parameters.  ``remat`` wraps each layer in a non-reentrant
    ``torch.utils.checkpoint``: nothing inside a layer is saved for the
    backward pass, which recomputes it (the JAX package's save-nothing
    ``jax.checkpoint``).  It changes no value, and where autograd records
    nothing it is skipped.  With ``cfg.remat_save_collectives`` and a
    ``ctx``, a layer's model-axis all-reduce outputs are kept from its
    forward and its recomputation replays them instead of reducing again
    (the JAX package's ``save_only_these_names("tp_psum_out")``: 6 to 4
    all-reduces a dense layer, forward plus backward).  ``ctx``: see the
    module docstring; the logits are gathered to the full vocabulary.
    """
    logits, aux, cache, split = _forward(params, cfg, tokens, embeds, remat,
                                         collect_cache, last_logit_only, ctx)
    return _full_logits(logits, split, ctx), aux, cache


def _forward(params, cfg: ArchConfig, tokens, embeds, remat: bool,
             collect_cache: bool, last_logit_only: bool, ctx):
    """``forward`` with the logits as ``_unembed`` leaves them."""
    x = _embed(tokens, params["embed"], cfg, ctx) if embeds is None \
        else embeds
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    wrap = remat and torch.is_grad_enabled()
    kw = {}
    if ctx is not None and cfg.remat_save_collectives:
        kw["context_fn"] = collective_tape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.num_layers):
        ig = _is_global_layer(cfg, i) if cfg.sliding_window else None
        lp = _layer(params["layers"], i)
        if wrap:
            x, a, cache = torch.utils.checkpoint.checkpoint(
                _block_train, x, lp, cfg, positions, ig, collect_cache, ctx,
                use_reentrant=False, **kw)
        else:
            x, a, cache = _block_train(x, lp, cfg, positions, is_global=ig,
                                       collect_cache=collect_cache, ctx=ctx)
        aux = aux + a
        caches.append(cache)
    if last_logit_only:
        x = x[:, -1:, :]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits, split = _unembed(x, params["unembed"], cfg, ctx)
    return logits, aux, (_stack(caches) if collect_cache else None), split


def loss_fn(params, batch, cfg: ArchConfig, aux_coef: float = 0.01,
            remat: bool = True, ctx=None):
    """Next-token cross-entropy: -> (nll + aux_coef * aux, {"nll", "aux"}).

    ``batch`` holds ``labels`` (B, T) and ``tokens`` (B, T) or ``embeds``
    (B, T, d).  The nll is the mean of logsumexp minus the gold logit over
    the float32 logits.  Under ``ctx`` the batch is this rank's rows and
    the nll the data group's mean, with this rank's gradient (the train
    step averages the gradients over the group)."""
    logits, aux, _, split = _forward(params, cfg, batch.get("tokens"),
                                     batch.get("embeds"), remat, False,
                                     False, ctx)
    nll = mean_over_dp(_nll(logits, batch["labels"], split, ctx), ctx)
    return nll + aux_coef * aux, {"nll": nll, "aux": aux}


# ----------------------------------------------------------------------------
# Decode (serving): KV/SSM caches, one-token step
# ----------------------------------------------------------------------------
def _kv_zeros(shape, dtype, device):
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None,
               ctx=None):
    """Zeroed decode cache for ``max_seq`` positions (unused by the ssm
    family, whose cache does not grow); this rank's kv heads and Mamba
    heads under ``ctx``."""
    dtype = _dtype(cfg)
    lcount = cfg.num_layers
    if cfg.family == "ssm":
        one = SSM.init_ssm_cache(cfg, batch, dtype, device, ctx)
        return {k: torch.zeros((lcount,) + tuple(a.shape), dtype=a.dtype,
                               device=a.device)
                for k, a in one.items()}
    kv = cfg.num_kv_heads
    if split_ctx(ctx, L.attn_layout, cfg) is not None:
        kv //= ctx.tp_size
    kvshape = (kv, cfg.head_dim)
    if cfg.family == "hybrid":
        caches = []
        for i in range(lcount):
            s = max_seq if _is_global_layer(cfg, i) else min(
                cfg.sliding_window, max_seq)
            c = _kv_zeros((batch, s) + kvshape, dtype, device)
            c["ssm"] = SSM.init_ssm_cache(cfg, batch, dtype, device, ctx)
            caches.append(c)
        return caches
    # dense / moe: uniform stacked KV, int8 on request
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    return _kv_zeros((lcount, batch, max_seq) + kvshape, kv_dtype, device)


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int):
    """``init_cache``'s tree on the meta device, no storage allocated
    (JAX: ``jax.eval_shape`` of ``init_cache``)."""
    return init_cache(cfg, batch, max_seq, device="meta")


def decode_cache_from_prefill(cfg: ArchConfig, pcache, max_seq: int,
                              ctx=None):
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

    Under ``ctx`` both caches are this rank's.
    """
    if cfg.family == "ssm":
        return pcache
    batch, t = pcache["k"].shape[1:3]
    if t > max_seq:
        raise ValueError(f"prefill of {t} tokens does not fit a decode cache "
                         f"of {max_seq} positions")
    cache = init_cache(cfg, batch, max_seq, pcache["k"].device, ctx)
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


def decode_step(params, cache, tokens, position: int, cfg: ArchConfig,
                ctx=None):
    """One decode step.  tokens: (B, 1) integer; ``position``: the
    position of ``tokens`` (unused by the ssm family).  Returns (logits
    (B, 1, V) float32, new_cache); KV caches are updated in place.
    ``ctx``: this rank's rows, shard and cache; full-vocabulary logits."""
    x = _embed(tokens, params["embed"], cfg, ctx)
    fctx = split_ctx(ctx, L.ffn_layout, cfg.d_ff, cfg.ffn_activation)

    if cfg.family == "ssm":
        new = []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h, nc = SSM.mamba_decode(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                     _layer(cache, i), lp["ssm"], cfg,
                                     ctx=ctx)
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
                window=0 if is_g else win, ctx=ctx)
            ssm_out, nssm = SSM.mamba_decode(xa, c["ssm"], lp["ssm"], cfg,
                                             ctx=ctx)
            attn_out = L.rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps)
            ssm_out = L.rms_norm(ssm_out, lp["ssm_norm"], cfg.norm_eps)
            x = x + 0.5 * (attn_out + ssm_out)
            tips_mask = (sink < cfg.tips_threshold) if cfg.tips else None
            xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.ffn(xf, lp, cfg.ffn_activation,
                          tips_important=tips_mask, ctx=fctx)
            new_cache.append({"k": ck, "v": cv, "ssm": nssm})
    else:
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            attn_out, _, _, sink = L.decode_attention(
                xa, lp, cfg, cache["k"][i], cache["v"][i], position, ctx=ctx)
            x = x + attn_out
            tips_mask = (sink < cfg.tips_threshold) if cfg.tips else None
            xf = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                f, _ = MOE.moe_ffn(xf, lp["moe"], cfg,
                                   tips_important=tips_mask, ctx=ctx)
            else:
                f = L.ffn(xf, lp, cfg.ffn_activation,
                          tips_important=tips_mask, ctx=fctx)
            x = x + f
        new_cache = cache

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits, split = _unembed(x, params["unembed"], cfg, ctx)
    return _full_logits(logits, split, ctx), new_cache


def prefill(params, cfg: ArchConfig, tokens=None, embeds=None, ctx=None):
    """Prefill: last-token logits + the populated per-layer cache (this
    rank's under ``ctx``)."""
    logits, _, cache = forward(params, cfg, tokens=tokens, embeds=embeds,
                               remat=False, collect_cache=True,
                               last_logit_only=True, ctx=ctx)
    return logits, cache
