"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro.models.moe``, its single-device path).

Each token picks its top-k experts; its place in an expert's buffer is a
cumsum over the one-hot assignment matrix, and a token past the
expert's capacity is dropped (its combine weight is zero), as production
MoE stacks do.  Shared experts, where the config has them, run on every
token.

The JAX package's expert- and tensor-parallel ``shard_map`` path,
``moe_mode`` and ``moe_param_specs`` come with multi-GPU serving
(ROADMAP.md, Queue 1 item 4b): here every expert runs on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tips as tips_mod
from repro_torch.models.layers import silu


def init_moe_params(generator: torch.Generator, cfg: ArchConfig, dtype):
    """Random parameters on the generator's device, with the JAX package's
    shapes and scales (the router in float32)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = d ** -0.5
    dev = generator.device

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
               capacity_factor: float):
    """x: (N, d) tokens -> (y (N, d), aux load-balance loss)."""
    n, d = x.shape
    e, k = cfg.num_experts, cfg.top_k

    logits = torch.einsum("nd,de->ne", x.to(torch.float32), router)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)          # (n, k)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)

    cap = capacity(cfg, n, capacity_factor)
    flat_e = top_idx.reshape(-1)
    flat_w = top_vals.reshape(-1)
    mypos, keep = dispatch_positions(top_idx, e, cap)
    safe_e = torch.where(keep, flat_e, 0)
    safe_p = torch.where(keep, mypos, cap - 1)

    # gather tokens into (e, cap, d) buffers: a scatter-add, in which a
    # dropped assignment adds zeros at (0, cap - 1) (exact in any order).
    # Assignment i is token i // k: each token's row repeated k times, by
    # a broadcast whose backward is a sum over k in a fixed order (an
    # index gather's backward would add the k rows with atomics)
    x_rep = x[:, None].expand(n, k, d).reshape(n * k, d)
    xe = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, safe_e * cap + safe_p,
                  torch.where(keep[:, None], x_rep, 0).to(x.dtype))
    xe = xe.view(e, cap, d)

    # expert FFN (SwiGLU)
    g = torch.einsum("ecd,edf->ecf", xe, wg)
    u = torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", silu(g) * u, wd)        # (e, cap, d)

    # combine: each token's k weighted expert outputs, rounded to x's
    # dtype first (a dropped slot contributes zeros)
    contrib = ye[safe_e, safe_p] * torch.where(keep, flat_w, 0.0)[:, None]
    y = combine(contrib.to(x.dtype), k)

    me = gates.mean(dim=0)                                    # (e,)
    ce = F.one_hot(top_idx, e).to(torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y, aux


def moe_ffn(x, p, cfg: ArchConfig, capacity_factor: float | None = None,
            tips_important=None):
    """(B, T, d) -> (y (B, T, d), aux) mixture-of-experts FFN (+ shared
    experts).  ``tips_important`` as in ``layers.ffn``."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if tips_important is not None:
        x = tips_mod.apply_precision_mask(x, tips_important)
    b, t, d = x.shape
    y, aux = _local_moe(x.reshape(-1, d), p["router"], p["we_gate"],
                        p["we_up"], p["we_down"], cfg=cfg,
                        capacity_factor=capacity_factor)
    y = y.reshape(b, t, d)
    if cfg.num_shared_experts:
        g = torch.einsum("btd,df->btf", x, p["ws_gate"])
        u = torch.einsum("btd,df->btf", x, p["ws_up"])
        y = y + torch.einsum("btf,fd->btd", silu(g) * u, p["ws_down"])
    return y, aux
