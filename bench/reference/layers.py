"""Plain PyTorch layers of the reference: the primitives, and one
transformer block with the paper's three features written out.

  * PSSA: softmax scores pruned at a fixed threshold; per cond row, the
    kept-score count (``nnz``) and the population of the key-axis patch
    XOR of the keep bitmap (``ones_xor``).
  * TIPS: the CLS column of the cross-attention probabilities averaged
    over heads (CAS); a token is important where CAS < threshold.
  * DBSC: both GEGLU matmuls on integers.  Activations are unsigned INT12
    on ONE scale over the call's whole (rows x tokens, C) matrix, rows
    that are not important drop the low 6 bits (INT6 on the same grid),
    weights are signed INT8 per tensor, the product is exact and wraps to
    int32, the output is ``acc * (sx * sw)``.

Activations are NHWC, conv weights OIHW, linear weights (in, out) applied
as ``x @ w``.  ``dense=True`` replaces the three features by the plain
float operations (the dense mathematics the FLOP count is taken over).

The classifier-free-guidance batch is ``[cond | uncond]`` from the start:
the two halves are equal until the first cross-attention, so this is the
same arithmetic as running the shared prefix once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACT_MAX = 4095          # unsigned INT12
WEIGHT_MAX = 127        # signed INT8


def conv2d(x, w, b=None, stride: int = 1, padding: int = 1):
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    n, h, w, c = x.shape
    g = math.gcd(groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * scale + bias


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def upsample2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def patch_size(resolution: int) -> int:
    """PSSA bitmap patch width at a feature-map resolution."""
    return min(64, max(16, resolution))


def _heads(x, w, heads):
    b, t, _ = x.shape
    return (x @ w).reshape(b, t, heads, -1).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ----------------------------------------------------------------------------
# DBSC: the integer FFN matmul
# ----------------------------------------------------------------------------
def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    x = torch.bitwise_and(x, 0xFFFFFFFF)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def dbsc_matmul(x: torch.Tensor, w: torch.Tensor, important=None):
    """(M, K) float @ (K, N) float through the integer datapath."""
    amax = torch.clamp_min(x, 0.0).max()
    sx = torch.clamp_min(amax, 1e-8) * (1.0 / ACT_MAX)
    codes = torch.clamp(torch.round(x / sx), 0, ACT_MAX).to(torch.int64)
    if important is not None:
        low = torch.bitwise_left_shift(torch.bitwise_right_shift(codes, 6), 6)
        codes = torch.where(important[:, None], codes, low)
    sw = torch.clamp_min(w.abs().max(), 1e-8) * (1.0 / WEIGHT_MAX)
    qw = torch.clamp(torch.round(w / sw), -WEIGHT_MAX - 1, WEIGHT_MAX)
    # exact: every partial sum of 4095 * 128 * K stays below 2**53
    acc = (codes.double() @ qw.double()).to(torch.int64)
    return _wrap_int32(acc).to(torch.float32) * (sx.to(torch.float32)
                                                 * sw.to(torch.float32))


# ----------------------------------------------------------------------------
# The transformer block
# ----------------------------------------------------------------------------
def _pssa(q, k, v, threshold: float, patch: int, n_cond: int, dense: bool):
    """Self-attention with the scores pruned; counters of the cond rows."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(float(q.shape[-1]))
    probs = torch.softmax(scores, dim=-1)
    if dense:
        return probs @ v, None
    keep = probs >= threshold
    out = torch.where(keep, probs, torch.zeros((), device=q.device)) @ v
    kc = keep[:n_cond]
    tk = kc.shape[-1]
    r = kc.reshape(*kc.shape[:-1], tk // patch, patch)
    nnz = kc.sum(dim=(1, 2, 3), dtype=torch.int64)
    first = r[..., 0, :].sum(dim=(1, 2, 3), dtype=torch.int64)
    delta = torch.logical_xor(r[..., 1:, :], r[..., :-1, :]).sum(
        dim=(1, 2, 3, 4), dtype=torch.int64)
    return out, (nnz, first + delta)


def transformer_block(x2d, p, context, heads: int, groups: int, feat: dict,
                      tips_active, n_cond: int, modulation=None,
                      dense: bool = False):
    """(B, H, W, C) -> (out, counters or None).

    ``feat``: ``pssa_threshold``, ``tips_threshold`` and ``cls_index``.
    ``tips_active`` (B,) bool: rows whose TIPS window is open.  ``n_cond``:
    the leading cond rows the counters cover.  ``modulation``: DiT's nine
    (B, 1, C) adaLN vectors, (shift, scale, gate) per stage.
    Counters: (nnz, ones_xor, important) each (n_cond,) int64.
    """
    b, hgt, wid, c = x2d.shape

    def mod(i, hn):
        if modulation is None:
            return hn
        return hn * (1.0 + modulation[3 * i + 1]) + modulation[3 * i]

    def gate(i, x):
        return x if modulation is None else x * modulation[3 * i + 2]

    h = group_norm(x2d, p["norm_in"]["scale"], p["norm_in"]["bias"],
                   groups).reshape(b, hgt * wid, c)
    h = h @ p["proj_in"]["w"] + p["proj_in"]["b"]

    hn = mod(0, layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"]))
    q = _heads(hn, p["sa_q"]["w"], heads)
    k = _heads(hn, p["sa_k"]["w"], heads)
    v = _heads(hn, p["sa_v"]["w"], heads)
    sa, pssa_counts = _pssa(q, k, v, feat["pssa_threshold"],
                            patch_size(hgt), n_cond, dense)
    h = h + gate(0, _merge(sa) @ p["sa_o"]["w"] + p["sa_o"]["b"])

    hn = mod(1, layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"]))
    q = _heads(hn, p["ca_q"]["w"], heads)
    kt = _heads(context, p["ca_k"]["w"], heads)
    vt = _heads(context, p["ca_v"]["w"], heads)
    probs = torch.softmax((q @ kt.transpose(-1, -2))
                          / math.sqrt(float(q.shape[-1])), dim=-1)
    h = h + gate(1, _merge(probs @ vt) @ p["ca_o"]["w"] + p["ca_o"]["b"])

    hn = mod(2, layer_norm(h, p["ln3"]["scale"], p["ln3"]["bias"]))
    t = hgt * wid
    if dense:
        gu = hn @ p["ff_geglu"]["w"] + p["ff_geglu"]["b"]
        g, u = torch.chunk(gu, 2, dim=-1)
        ffn = (gelu(g) * u) @ p["ff_out"]["w"] + p["ff_out"]["b"]
        counters = None
    else:
        cas = probs[..., :, feat["cls_index"]].mean(dim=1)       # (B, Tq)
        spotted = cas < feat["tips_threshold"]
        important = torch.logical_or(spotted,
                                     torch.logical_not(tips_active)[:, None])
        imp_flat = important.reshape(b * t)
        gu = dbsc_matmul(hn.reshape(b * t, c), p["ff_geglu"]["w"],
                         imp_flat).reshape(b, t, -1) + p["ff_geglu"]["b"]
        g, u = torch.chunk(gu, 2, dim=-1)
        mid = gelu(g) * u
        ffn = dbsc_matmul(mid.reshape(b * t, mid.shape[-1]),
                          p["ff_out"]["w"]).reshape(b, t, c) \
            + p["ff_out"]["b"]
        counters = (*pssa_counts,
                    spotted[:n_cond].sum(dim=-1, dtype=torch.int64))
    h = h + gate(2, ffn)
    h = h @ p["proj_out"]["w"] + p["proj_out"]["b"]
    return x2d + h.reshape(b, hgt, wid, c), counters
