"""Mamba-2 SSD (state-space duality) in PyTorch (port of
``repro.models.ssm``; arXiv:2405.21060).

Chunked SSD: the sequence is split into chunks; each chunk's diagonal
block is computed quadratically (attention-like), and information flows
between chunks through a small recurrent state.  Decode is the O(1)
recurrent update.  ``cfg.use_ssd_kernel`` routes the full-sequence scan
through the fused op (``kernels/ssd_scan``: the hand-written CUDA kernel
on the card).

Shapes follow the JAX package: x (B, T, H, P), dt (B, T, H), A (H,)
negative reals, B/C (B, T, N) with one group.  Casts mirror the JAX
package's: projections, the conv and the gated norm's output in the model
dtype; dt, A, D, the scan and the state in float32.

On a mesh the mixer runs split by HEADS, where ``ssm_heads`` divides the
model axis (``ssm_layout``).  That is not the layout of the JAX spec tree
(``ssm_param_specs``, kept verbatim): its ``in_xbc`` is ``P(None,
"model")`` over ``d_inner + 2 n`` channels, and a contiguous cut there
would split across the x / B / C segments, which GSPMD handles by moving
data.  Here a rank holds, for its heads, the columns of ``in_z``, the x
columns of ``in_xbc`` with their conv channels, the columns of ``in_dt``,
``A_log`` / ``D`` / ``dt_bias``, ``gate_norm`` and the rows of
``out_proj``; B and C (shared by every head) it computes whole.  The
gated norm over ``d_inner`` all-reduces its sum of squares, and
``out_proj`` is row-parallel.  The decode cache follows: state (B,
H / tp, P, N), conv window over [this rank's x channels | B | C]; the
spec tree's cache splits P instead.  Elsewhere the mixer runs replicated.
The kernel route hands ``ssd_scan_fused`` this rank's heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan.ops import pick_chunk, ssd_scan_fused
from repro_torch.models.layers import rms_norm, silu
from repro_torch.models.parallel import (P, Split, copy_to_tp,
                                         reduce_from_tp, split_ctx,
                                         sum_over_tp)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular segment sums.

    out[..., l, s] = sum_{s < i <= l} x[..., i]  (for l >= s, else -inf)
    """
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and compute on in float32: a bf16 operand of a
    JAX dot with ``preferred_element_type=float32``."""
    return a.to(torch.bfloat16).to(torch.float32)


# The products of the SSD's einsums that sum no index.  The JAX package's
# einsums contract their operands in pairs (opt_einsum's path), each pair a
# ``dot_general`` that its FLOP count includes, with two more in the
# backward (one an operand); torch computes a pair that sums nothing as a
# broadcast multiply, which ``FlopCounterMode`` does not count.  As custom
# ops with flop formulas (``SSD_PRODUCT_FLOPS``) the port's counter sees
# them too; their values are those of the multiply and of its autograd.
@torch.library.custom_op("repro_torch::ssd_product", mutates_args=())
def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b``, broadcast (the operands aligned by the caller)."""
    return a * b


@torch.library.custom_op("repro_torch::ssd_product_grad", mutates_args=())
def product_grad(grad: torch.Tensor, other: torch.Tensor,
                 shape: list[int]) -> torch.Tensor:
    """One operand's gradient: ``grad * other`` summed to ``shape``."""
    return (grad * other).sum_to_size(shape)


@product.register_fake
def _(a, b):
    return a.new_empty(torch.broadcast_shapes(a.shape, b.shape))


@product_grad.register_fake
def _(grad, other, shape):
    return grad.new_empty(shape)


def _product_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _product_backward(ctx, grad):
    a, b = ctx.saved_tensors
    return (product_grad(grad, b, list(a.shape))
            if ctx.needs_input_grad[0] else None,
            product_grad(grad, a, list(b.shape))
            if ctx.needs_input_grad[1] else None)


product.register_autograd(_product_backward, setup_context=_product_setup)


SSD_PRODUCT_FLOPS = {
    torch.ops.repro_torch.ssd_product:
        lambda a, b, *_, out_shape=None, **__: 2 * math.prod(out_shape),
    torch.ops.repro_torch.ssd_product_grad:
        lambda grad, *_, **__: 2 * math.prod(grad)}


def ssd_scan(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD forward.

    x: (b, t, h, p); dt: (b, t, h) (post-softplus); A: (h,) < 0;
    B, C: (b, t, n) (single group).  Returns (y (b,t,h,p), state (b,h,p,n)).
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    if t % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide T={t}")
    c = t // chunk

    xdt = x * dt[..., None]                          # (b,t,h,p)
    dA = dt * A[None, None, :]                       # (b,t,h)

    xc = xdt.reshape(b, c, chunk, h, p)
    Bc = B.reshape(b, c, chunk, n)
    Cc = C.reshape(b, c, chunk, n)
    dAc = dA.reshape(b, c, chunk, h)

    dA_cum = torch.cumsum(dAc, dim=2)                # (b,c,l,h)

    # 1) intra-chunk (diagonal blocks).  The JAX package rounds scores,
    # the decay tile and x to bfloat16 and accumulates in float32; the
    # product of two bf16 values is exact in float32.
    Ldec = torch.exp(_segsum(dAc.movedim(3, 2)))    # (b,c,h,l,l)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # (b,c,l,s)
    y_diag = torch.einsum("bchls,bcshp->bclhp",
                          product(_bf16(scores)[:, :, None], _bf16(Ldec)),
                          _bf16(xc))

    # 2) per-chunk states: contribution of each chunk to the running state
    # (JAX's pairs: the decay times x, then B over l)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,c,l,h)
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          product(decay_to_end[..., None], xc))

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])     # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)           # (b,c,h,p,n)

    # 4) off-diagonal: prior state read out through the chunk
    # (JAX's pairs: C times the decay, then the states over n)
    state_decay_in = torch.exp(dA_cum)               # (b,c,l,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         product(Cc[:, :, :, None], state_decay_in[..., None]),
                         prev_states)

    y = (y_diag + y_off).reshape(b, t, h, p)
    return y, carry


def ssd_decode_step(x, dt, A, B, C, state):
    """O(1) recurrent update.  x: (b,h,p); dt: (b,h); B,C: (b,n);
    state: (b,h,p,n) -> (y (b,h,p), new_state)."""
    dA = torch.exp(dt * A[None, :])                  # (b,h)
    # JAX's pairs: B times dt, then times x
    dBx = product(product(B[:, None], dt[..., None])[:, :, None],
                  x[..., None])
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y, new_state


# ----------------------------------------------------------------------------
# Full Mamba-2 mixer layer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ----------------------------------------------------------------------------
def init_ssm_params(generator: torch.Generator, cfg: ArchConfig, dtype,
                    device=None):
    """Random parameters on ``device`` (the generator's by default), with
    the JAX package's shapes and scales (the input projection split into
    z, xBC and dt)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    dev = generator.device if device is None else device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dtype)

    return {
        "in_z": normal((d, di), d ** -0.5),
        "in_xbc": normal((d, conv_ch), d ** -0.5),
        "in_dt": normal((d, h), d ** -0.5),
        "conv_w": normal((cfg.ssm_conv_width, conv_ch), 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal((di, d), di ** -0.5),
    }


def ssm_param_specs(cfg: ArchConfig):
    return {
        "in_z": P(None, "model"),
        "in_xbc": P(None, "model"),
        "in_dt": P(None, None),         # heads (24/50) rarely divide TP=16
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "gate_norm": P("model"),
        "out_proj": P("model", None),
    }


def ssm_layout(cfg: ArchConfig, tp: int):
    """How ``init_ssm_params``' leaves split: by heads where they divide
    the model axis (module docstring), else None (replicated)."""
    names = ("in_z", "in_xbc", "in_dt", "conv_w", "conv_b", "A_log", "D",
             "dt_bias", "gate_norm", "out_proj")
    if cfg.ssm_heads % tp:
        return dict.fromkeys(names)
    di = cfg.d_inner
    return {"in_z": Split(1), "in_xbc": Split(1, di), "in_dt": Split(1),
            "conv_w": Split(1, di), "conv_b": Split(0, di),
            "A_log": Split(0), "D": Split(0), "dt_bias": Split(0),
            "gate_norm": Split(0), "out_proj": Split(0)}


def _gated_norm(y, z, scale, cfg: ArchConfig, ctx):
    """``rms_norm(y * silu(z), scale)`` over d_inner; split, the sum of
    squares of this rank's channels is all-reduced first."""
    if ctx is None or ctx.tp_size == 1:
        return rms_norm(y * silu(z), scale, cfg.norm_eps)
    x = y * silu(z)
    xf = x.to(torch.float32)
    var = sum_over_tp(xf.square().sum(dim=-1, keepdim=True), ctx) \
        / cfg.d_inner
    out = xf * torch.rsqrt(var + cfg.norm_eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def _in_proj(x, p, ctx):
    """(z, xBC, dt) projections of (..., d) ``x``.  Split over more than
    one rank, the x channels come from ``copy_to_tp(x)`` and B, C (whole
    on every rank) from ``x`` itself, since their gradient is whole."""
    xp = copy_to_tp(x, ctx)
    z = torch.einsum("...d,dk->...k", xp, p["in_z"])
    dt = torch.einsum("...d,dk->...k", xp, p["in_dt"])
    if ctx is None or ctx.tp_size == 1:
        return z, torch.einsum("...d,dk->...k", xp, p["in_xbc"]), dt
    dl = p["in_z"].shape[-1]
    xbc = torch.cat([torch.einsum("...d,dk->...k", xp, p["in_xbc"][:, :dl]),
                     torch.einsum("...d,dk->...k", x, p["in_xbc"][:, dl:])],
                    dim=-1)
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width W, via shifted adds (W is tiny)."""
    W = w.shape[0]
    t = xBC.shape[1]
    out = xBC * w[-1]
    for i in range(1, W):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :t, :]
        out = out + shifted * w[-1 - i]
    return out + b


def mamba_mixer(x, p, cfg: ArchConfig, chunk: int = 128,
                return_cache: bool = False, *, ctx=None):
    """Full-sequence Mamba-2 mixer: (B, T, d) -> (B, T, d); with
    ``return_cache`` also the decode cache {"state", "conv"}.  ``ctx``:
    split by heads (module docstring), ``p`` and the cache this rank's."""
    b, t, d = x.shape
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    ctx = split_ctx(ctx, ssm_layout, cfg)
    di = p["in_z"].shape[-1]                  # this rank's channels
    h = di // hd
    z, xBC_raw, dt = _in_proj(x, p, ctx)
    xBC = silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(b, t, h, hd)
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
    if ctx is not None and ctx.tp_size > 1:
        Bm, Cm = copy_to_tp(Bm, ctx), copy_to_tp(Cm, ctx)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    ck = pick_chunk(t, chunk)
    if cfg.use_ssd_kernel:
        y, final_state = ssd_scan_fused(xs, dt, A, Bm, Cm, chunk=ck)
    else:
        y, final_state = ssd_scan(xs.to(torch.float32), dt, A,
                                  Bm.to(torch.float32),
                                  Cm.to(torch.float32), ck)
    y = y + xs.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, t, di).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg, ctx)
    out = reduce_from_tp(torch.einsum("btk,kd->btd", y, p["out_proj"]), ctx)
    if return_cache:
        w = cfg.ssm_conv_width
        cache = {"state": final_state,
                 "conv": xBC_raw[:, t - (w - 1):, :]}
        return out, cache
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device=None,
                   ctx=None):
    """Decode cache per layer: recurrent state + conv window (this rank's
    heads and channels under a split ``ctx``)."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    if split_ctx(ctx, ssm_layout, cfg) is not None:
        di, h = di // ctx.tp_size, h // ctx.tp_size
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba_decode(x, cache, p, cfg: ArchConfig, *, ctx=None):
    """One-token decode: x (B, 1, d) -> (out (B, 1, d), new cache);
    ``ctx`` as in ``mamba_mixer``."""
    b = x.shape[0]
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    ctx = split_ctx(ctx, ssm_layout, cfg)
    di = p["in_z"].shape[-1]
    h = di // hd
    z, xBC, dt = _in_proj(x[:, 0], p, ctx)
    # conv over the rolling window
    win = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)
    new_conv = win[:, 1:, :]
    conv_out = torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"]
    xBC = silu(conv_out)
    xs = xBC[..., :di].reshape(b, h, hd).to(torch.float32)
    Bm = xBC[..., di:di + n].to(torch.float32)
    Cm = xBC[..., di + n:].to(torch.float32)
    if ctx is not None and ctx.tp_size > 1:
        Bm, Cm = copy_to_tp(Bm, ctx), copy_to_tp(Cm, ctx)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y, new_state = ssd_decode_step(xs, dt, A, Bm, Cm, cache["state"])
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg, ctx)
    out = reduce_from_tp(y @ p["out_proj"], ctx)[:, None, :]
    return out, {"state": new_state, "conv": new_conv}
