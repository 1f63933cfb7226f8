"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro.models.moe``).

Each token picks its top-k experts; its place in an expert's buffer is a
cumsum over the one-hot assignment matrix, and a token past the
expert's capacity is dropped (its combine weight is zero), as production
MoE stacks do.  Shared experts, where the config has them, run on every
token.

On a mesh (``ctx``) the JAX package's ``shard_map`` body runs on each rank
(``moe_mode``): in ``ep`` mode a rank holds ``E / tp`` experts and drops
the assignments to the others (``base = rank * e_local``); in ``tp`` mode
it holds every expert with ``moe_d_ff / tp`` of its hidden width.  Either
way its output is a partial sum, and one model-axis all-reduce combines it
(with the shared experts' row-parallel partial, where those split too).
The router runs replicated; the tokens and the combine weights enter the
split part through ``copy_to_tp``.  Capacity comes from the rank's own
token count, as in the JAX body, and the aux loss is its mean over the
data axes.  Where neither the experts nor their width divide the model
axis, the experts run replicated.  A part runs split exactly where its
layout (``expert_layout``, ``shared_layout``) splits its weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tips as tips_mod
from repro_torch.models.layers import silu
from repro_torch.models.parallel import (P, Split, copy_to_tp, mean_over_dp,
                                         reduce_from_tp, split_ctx)


def init_moe_params(generator: torch.Generator, cfg: ArchConfig, dtype,
                    device=None):
    """Random parameters on ``device`` (the generator's by default), with
    the JAX package's shapes and scales (the router in float32)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = d ** -0.5
    dev = generator.device if device is None else device

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dt)
    p = {"router": normal((d, e), s, torch.float32),
         "we_gate": normal((e, d, f), s),
         "we_up": normal((e, d, f), s),
         "we_down": normal((e, f, d), f ** -0.5)}
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["ws_gate"] = normal((d, fs), s)
        p["ws_up"] = normal((d, fs), s)
        p["ws_down"] = normal((fs, d), fs ** -0.5)
    return p


def moe_mode(cfg: ArchConfig, tp_size: int) -> str:
    return "ep" if cfg.num_experts % tp_size == 0 else "tp"


def moe_param_specs(cfg: ArchConfig, tp_size: int):
    if moe_mode(cfg, tp_size) == "ep":
        expert = {"we_gate": P("model", None, None),
                  "we_up": P("model", None, None),
                  "we_down": P("model", None, None)}
    else:
        expert = {"we_gate": P(None, None, "model"),
                  "we_up": P(None, None, "model"),
                  "we_down": P(None, "model", None)}
    p = {"router": P(None, None), **expert}
    if cfg.num_shared_experts:
        p.update({"ws_gate": P(None, "model"),
                  "ws_up": P(None, "model"),
                  "ws_down": P("model", None)})
    return p


def expert_layout(cfg: ArchConfig, tp: int):
    """How the routed experts' leaves split: by expert (ep), by hidden
    width (tp mode, where it divides), else None (replicated)."""
    names = ("we_gate", "we_up", "we_down")
    if moe_mode(cfg, tp) == "ep":
        return dict.fromkeys(names, Split(0))
    if cfg.moe_d_ff % tp == 0:
        return {"we_gate": Split(2), "we_up": Split(2), "we_down": Split(1)}
    return dict.fromkeys(names)


def shared_layout(cfg: ArchConfig, tp: int):
    """How the shared experts' leaves split (by hidden width, where it
    divides); empty without shared experts."""
    if not cfg.num_shared_experts:
        return {}
    ok = (cfg.moe_d_ff * cfg.num_shared_experts) % tp == 0
    return {"ws_gate": Split(1) if ok else None,
            "ws_up": Split(1) if ok else None,
            "ws_down": Split(0) if ok else None}


def moe_layout(cfg: ArchConfig, tp: int):
    """How ``init_moe_params``' leaves split (None: replicated)."""
    return {"router": None, **expert_layout(cfg, tp),
            **shared_layout(cfg, tp)}


def capacity(cfg: ArchConfig, n: int, capacity_factor: float) -> int:
    """Slots per expert for ``n`` tokens (at least 8)."""
    return max(8, int(cfg.top_k * n * capacity_factor) // cfg.num_experts)


def dispatch_positions(top_idx: torch.Tensor, num_experts: int, cap: int):
    """(n, k) expert choices -> (position of each of the n*k assignments
    in its expert's buffer, kept).  Assignments are taken in token order,
    a token's k choices in rank order; positions start at 0.  The cumsum
    over assignments runs along the contiguous axis of the transposed
    one-hot matrix (a scan along the outer axis of (n*k, e) is slow on the
    card); the integers are the same."""
    onehot = F.one_hot(top_idx.reshape(-1), num_experts).t().contiguous()
    pos = torch.cumsum(onehot, dim=1) - onehot                # (e, n*k)
    mypos = (pos * onehot).sum(dim=0)                         # (n*k,)
    return mypos, mypos < cap


def combine(contrib: torch.Tensor, k: int) -> torch.Tensor:
    """(n*k, d) assignment rows -> (n, d): token t sums rows t*k ..
    t*k + k - 1 in rank order, rounding after each add in their dtype.
    A fixed order, so the same bits on every run (a scatter-add by token
    adds them with atomics on the card, in no fixed order)."""
    parts = contrib.view(-1, k, contrib.shape[-1])
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def _local_moe(x, router, wg, wu, wd, *, cfg: ArchConfig,
               capacity_factor: float, ctx=None, base=None):
    """x: (N, d) tokens -> (y (N, d), aux load-balance loss).  With
    ``ctx`` the weights are this rank's slice and ``y`` its partial sum;
    ``base``: the first of this rank's experts (ep mode)."""
    n, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    e_local = wg.shape[0]

    logits = torch.einsum("nd,de->ne", x.to(torch.float32), router)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)          # (n, k)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)

    cap = capacity(cfg, n, capacity_factor)
    flat_e = top_idx.reshape(-1)
    flat_w = top_vals.reshape(-1)
    mypos, keep = dispatch_positions(top_idx, e, cap)
    if base is not None:
        # ep: this rank's experts only; the others' assignments drop here
        keep = keep & (flat_e >= base) & (flat_e < base + e_local)
        flat_e = flat_e - base
    safe_e = torch.where(keep, flat_e, 0)
    safe_p = torch.where(keep, mypos, cap - 1)

    # gather tokens into (e, cap, d) buffers: a scatter-add, in which a
    # dropped assignment adds zeros at (0, cap - 1) (exact in any order).
    # Assignment i is token i // k: each token's row repeated k times, by
    # a broadcast whose backward is a sum over k in a fixed order (an
    # index gather's backward would add the k rows with atomics)
    xs = copy_to_tp(x, ctx)
    x_rep = xs[:, None].expand(n, k, d).reshape(n * k, d)
    xe = torch.zeros((e_local * cap, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, safe_e * cap + safe_p,
                  torch.where(keep[:, None], x_rep, 0).to(x.dtype))
    xe = xe.view(e_local, cap, d)

    # expert FFN (SwiGLU)
    g = torch.einsum("ecd,edf->ecf", xe, wg)
    u = torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", silu(g) * u, wd)        # (e, cap, d)

    # combine: each token's k weighted expert outputs, rounded to x's
    # dtype first (a dropped slot contributes zeros)
    flat_w = copy_to_tp(flat_w, ctx)
    contrib = ye[safe_e, safe_p] * torch.where(keep, flat_w, 0.0)[:, None]
    y = combine(contrib.to(x.dtype), k)

    me = gates.mean(dim=0)                                    # (e,)
    ce = F.one_hot(top_idx, e).to(torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y, aux


def moe_ffn(x, p, cfg: ArchConfig, capacity_factor: float | None = None,
            tips_important=None, *, ctx=None):
    """(B, T, d) -> (y (B, T, d), aux) mixture-of-experts FFN (+ shared
    experts).  ``tips_important`` as in ``layers.ffn``; ``ctx``: ``p``
    holds this rank's slice as ``moe_layout`` cuts it, ``x`` this rank's
    rows."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if tips_important is not None:
        x = tips_mod.apply_precision_mask(x, tips_important)
    b, t, d = x.shape
    ectx = split_ctx(ctx, expert_layout, cfg)
    base = (ectx.tp_rank * p["we_gate"].shape[0]
            if ectx is not None and moe_mode(cfg, ectx.tp_size) == "ep"
            else None)
    y, aux = _local_moe(x.reshape(-1, d), p["router"], p["we_gate"],
                        p["we_up"], p["we_down"], cfg=cfg,
                        capacity_factor=capacity_factor, ctx=ectx, base=base)
    y = y.reshape(b, t, d)
    sctx = None
    if cfg.num_shared_experts:
        sctx = split_ctx(ctx, shared_layout, cfg)
        xs = copy_to_tp(x, sctx)
        g = torch.einsum("btd,df->btf", xs, p["ws_gate"])
        u = torch.einsum("btd,df->btf", xs, p["ws_up"])
        s = torch.einsum("btf,fd->btd", silu(g) * u, p["ws_down"])
        if (ectx is None) == (sctx is None):
            # both partial (one all-reduce for the two) or both whole
            y = y + s
        else:
            y = reduce_from_tp(y, ectx) + reduce_from_tp(s, sctx)
            ectx = sctx = None
    y = reduce_from_tp(y, ectx if ectx is not None else sctx)
    return y, mean_over_dp(aux, ctx)
