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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan.ops import pick_chunk, ssd_scan_fused
from repro_torch.models.layers import rms_norm, silu


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
                          _bf16(scores)[:, :, None] * _bf16(Ldec),
                          _bf16(xc))

    # 2) per-chunk states: contribution of each chunk to the running state
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,c,l,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_to_end, xc)

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
    state_decay_in = torch.exp(dA_cum)               # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states,
                         state_decay_in)

    y = (y_diag + y_off).reshape(b, t, h, p)
    return y, carry


def ssd_decode_step(x, dt, A, B, C, state):
    """O(1) recurrent update.  x: (b,h,p); dt: (b,h); B,C: (b,n);
    state: (b,h,p,n) -> (y (b,h,p), new_state)."""
    dA = torch.exp(dt * A[None, :])                  # (b,h)
    dBx = torch.einsum("bn,bh,bhp->bhpn", B, dt, x)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y, new_state


# ----------------------------------------------------------------------------
# Full Mamba-2 mixer layer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ----------------------------------------------------------------------------
def init_ssm_params(generator: torch.Generator, cfg: ArchConfig, dtype):
    """Random parameters on the generator's device, with the JAX package's
    shapes and scales (the input projection split into z, xBC and dt)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    dev = generator.device

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
                return_cache: bool = False):
    """Full-sequence Mamba-2 mixer: (B, T, d) -> (B, T, d); with
    ``return_cache`` also the decode cache {"state", "conv"}."""
    b, t, d = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = torch.einsum("btd,dk->btk", x, p["in_z"])
    xBC_raw = torch.einsum("btd,dk->btk", x, p["in_xbc"])
    dt = torch.einsum("btd,dk->btk", x, p["in_dt"])
    xBC = silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(b, t, h, hd)
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
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
    y = rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("btk,kd->btd", y, p["out_proj"])
    if return_cache:
        w = cfg.ssm_conv_width
        cache = {"state": final_state,
                 "conv": xBC_raw[:, t - (w - 1):, :]}
        return out, cache
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device=None):
    """Decode cache per layer: recurrent state + conv window."""
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "state": torch.zeros((batch, h, hd, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba_decode(x, cache, p, cfg: ArchConfig):
    """One-token decode: x (B, 1, d) -> (out (B, 1, d), new cache)."""
    b = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    z = x0 @ p["in_z"]
    xBC = x0 @ p["in_xbc"]
    dt = x0 @ p["in_dt"]
    # conv over the rolling window
    win = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)
    new_conv = win[:, 1:, :]
    conv_out = torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"]
    xBC = silu(conv_out)
    xs = xBC[..., :di].reshape(b, h, hd).to(torch.float32)
    Bm = xBC[..., di:di + n].to(torch.float32)
    Cm = xBC[..., di + n:].to(torch.float32)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y, new_state = ssd_decode_step(xs, dt, A, Bm, Cm, cache["state"])
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"state": new_state, "conv": new_conv}
