"""Shared LM layers: norms, RoPE, GQA attention (full-sequence, banded,
decode over a linear or a ring-buffer cache), the int8 KV grid, and the
FFN with the TIPS hook (port of ``repro.models.layers``).

The port has no mesh yet, so there is no ``ShardCtx``, no ``ctx``
argument, no ``maybe_cs`` and no ``*_param_specs``: they come with
multi-GPU serving (ROADMAP.md, Queue 1 item 4).  Casts mirror the JAX
package's: projections and the P V product in the activation dtype, the
softmax in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tips as tips_mod
from repro_torch.configs.base import ArchConfig


# ----------------------------------------------------------------------------
# Norms / embeddings / activations
# ----------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """Normalise in float32, scale in float32, return ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, T, d) @ (d, V) -> logits in float32."""
    return torch.einsum("btd,dv->btv", x.to(torch.float32),
                        table.to(torch.float32))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * 1 / (1 + e^-x), each op
    rounded to x's dtype.  In bfloat16 ``F.silu`` rounds once and lands an
    ulp away from the JAX package on ~40 % of values."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default), op for op in x's
    dtype, its constants rounded to that dtype as JAX rounds them."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype).item()
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# ----------------------------------------------------------------------------
# RoPE (partial rotary too: chatglm3's 2-D RoPE rotates half the dims)
# ----------------------------------------------------------------------------
def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     device=None):
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return inv, rot_dim


def _rope_tables(positions, head_dim: int, rotary_pct: float, theta: float):
    """(sin, cos) float32 (B, T, 1, rot/2) and rot_dim; rot_dim 0: no
    rotation."""
    inv, rot_dim = rope_frequencies(head_dim, rotary_pct, theta,
                                    positions.device)
    if rot_dim == 0:
        return None, None, 0
    ang = positions.to(torch.float32)[..., None] * inv     # (B, T, rot/2)
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :], rot_dim


def _rotate(x, sin, cos, rot_dim: int):
    if rot_dim == 0:
        return x
    xr = x[..., :rot_dim]
    xp = x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def apply_rope(x, positions, rotary_pct: float, theta: float):
    """x: (B, T, H, hd); positions: (B, T) or (T,).

    sin and cos are float32, so a bfloat16 ``x`` is promoted in the
    products and rounds once, when the rotated half is cast back."""
    return _rotate(x, *_rope_tables(positions, x.shape[-1], rotary_pct,
                                    theta))


# ----------------------------------------------------------------------------
# Attention (GQA: causal / sliding-window / decode with a cache) + PSSA hook
# ----------------------------------------------------------------------------
def init_attn_params(generator: torch.Generator, cfg: ArchConfig, dtype):
    """Random projections on the generator's device, with the JAX
    package's shapes and scale."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    dev = generator.device

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * s).to(dtype)
    return {"wq": normal((d, h * hd)), "wk": normal((d, kv * hd)),
            "wv": normal((d, kv * hd)), "wo": normal((h * hd, d))}


def _causal_mask(tq, tk, offset=0, device=None):
    q = torch.arange(tq, device=device)[:, None] + offset
    k = torch.arange(tk, device=device)[None, :]
    return q >= k


def _window_mask(tq, tk, window, offset=0, device=None):
    q = torch.arange(tq, device=device)[:, None] + offset
    k = torch.arange(tk, device=device)[None, :]
    return (q >= k) & (q - k < window)


def _project(x, p, cfg: ArchConfig, positions):
    """q (B, T, H, hd), k and v (B, T, KV, hd); RoPE on q and k."""
    b, t, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.einsum("btd,dk->btk", x, p["wq"]).reshape(b, t, h, hd)
    k = torch.einsum("btd,dk->btk", x, p["wk"]).reshape(b, t, kv, hd)
    v = torch.einsum("btd,dk->btk", x, p["wv"]).reshape(b, t, kv, hd)
    # RoPE on q and k from one table (as two apply_rope calls would give)
    tables = _rope_tables(positions, hd, cfg.rotary_pct, cfg.rope_theta)
    return _rotate(q, *tables), _rotate(k, *tables), v


def gqa_attention(x, p, cfg: ArchConfig, positions, window: int = 0,
                  prune_threshold: float = 0.0, q_chunk: int = 1024,
                  global_flag: bool | None = None):
    """Full-sequence causal GQA attention.  (B, T, d) -> (out (B, T, d),
    sink CAS (B, T) float32, (k, v)).

    ``prune_threshold`` > 0 applies PSSA step-1 pruning to the
    post-softmax scores.  ``window`` > 0 bands the mask; with
    ``global_flag`` given (a hybrid layer) the band applies only where the
    flag is False.  For T > q_chunk (T a multiple of it) the score block
    runs over query chunks, so at most (B, H, q_chunk, T) scores exist at
    a time.  Grouped-query einsums: KV is never repeated to full heads.
    """
    b, t, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project(x, p, cfg, positions)
    g = h // kv
    scale = math.sqrt(float(hd))

    def block(qb, offset):
        """qb: (b, qc, h, hd) -> (out (b, qc, h*hd), sink (b, qc))."""
        qc = qb.shape[1]
        qg = qb.reshape(b, qc, kv, g, hd)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / scale
        if window and global_flag is not None:
            mask = _causal_mask(qc, t, offset, x.device)
            if not global_flag:
                mask = mask & _window_mask(qc, t, window, offset, x.device)
        elif window:
            mask = _window_mask(qc, t, window, offset, x.device)
        else:
            mask = _causal_mask(qc, t, offset, x.device)
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores.to(torch.float32), dim=-1)
        if prune_threshold > 0.0:
            probs = torch.where(probs >= prune_threshold, probs, 0.0)
        # TIPS sink CAS: attention of every query to the first (sink)
        # token, averaged over heads
        sink = probs[..., 0].mean(dim=(1, 2))                 # (b, qc)
        ob = torch.einsum("bkgts,bskd->btkgd", probs.to(x.dtype), v)
        return ob.reshape(b, qc, h * hd), sink

    if t > q_chunk and t % q_chunk == 0:
        outs, sinks = zip(*(block(q[:, i:i + q_chunk], i)
                            for i in range(0, t, q_chunk)))
        out, sink_cas = torch.cat(outs, dim=1), torch.cat(sinks, dim=1)
    else:
        out, sink_cas = block(q, 0)
    out = torch.einsum("btk,kd->btd", out, p["wo"])
    return out, sink_cas, (k, v)


def swa_attention_chunked(x, p, cfg: ArchConfig, positions, window: int):
    """Banded (sliding-window) attention, sub-quadratic: queries are
    chunked at ``window`` and each chunk attends to itself and the
    previous chunk under the band mask.  No sink CAS (the sink leaves the
    band)."""
    b, t, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if t % window:
        raise ValueError(f"swa_attention_chunked: window {window} does not "
                         f"divide T={t}")
    nc = t // window
    q, k, v = _project(x, p, cfg, positions)
    g = h // kv
    qc = q.reshape(b, nc, window, kv, g, hd)
    kc = k.reshape(b, nc, window, kv, hd)
    vc = v.reshape(b, nc, window, kv, hd)
    # the previous chunk (zeros before the first)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kcat = torch.cat([kprev, kc], dim=2)             # (b, nc, 2w, kv, hd)
    vcat = torch.cat([vprev, vc], dim=2)
    scores = torch.einsum("bclkgh,bcskh->bckgls", qc, kcat) \
        / math.sqrt(float(hd))
    qpos = torch.arange(window, device=x.device)[:, None] + window
    kpos = torch.arange(2 * window, device=x.device)[None, :]
    band = (qpos >= kpos) & (qpos - kpos < window)
    first = torch.zeros((nc,), dtype=torch.bool, device=x.device)
    first[0] = True
    pad_valid = kpos >= window                       # first chunk: no prev
    mask = torch.where(first[:, None, None], band & pad_valid, band)
    scores = scores.masked_fill(~mask[None, :, None, None], -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.einsum("bckgls,bcskh->bclkgh", probs, vcat)
    out = out.reshape(b, t, h * hd)
    return torch.einsum("btk,kd->btd", out, p["wo"])


# int8 KV-cache grid: RoPE'd keys/values from unit-scale projections sit
# within ~|4|; 0.05 granularity covers +-6.35.
KV_INT8_SCALE = 0.05


def _scale_in(dtype: torch.dtype) -> float:
    """KV_INT8_SCALE as JAX carries it into an op on an array of
    ``dtype``: a Python float takes the array's dtype."""
    return torch.tensor(KV_INT8_SCALE, dtype=dtype).item()


def _kv_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cache's dtype; int8 on the KV_INT8_SCALE grid.  ``x / 0.05`` is
    taken as XLA takes it: a float32 product by the inverse of the scale
    in x's dtype, rounded to x's dtype, then rounded to an integer."""
    if dtype == torch.int8:
        inv = torch.tensor(1.0 / _scale_in(x.dtype),
                           dtype=torch.float32).item()
        q = (x.to(torch.float32) * inv).to(x.dtype)
        return torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return x.to(dtype)


def _kv_load(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.to(torch.bfloat16) * _scale_in(torch.bfloat16)
    return x


def decode_attention(x, p, cfg: ArchConfig, cache_k, cache_v, position: int,
                     window: int = 0):
    """Single-token decode with a KV cache.

    x: (B, 1, d); cache_k/v: (B, S, kv, hd); ``position``: the same for
    every row (the serving batch is position-aligned).  The new key and
    value are written into the caches in place (the JAX serve loop
    donates its cache buffers).  Returns (out (B, 1, d), cache_k, cache_v,
    sink CAS (B, 1)).

    As in the JAX package, q and the probabilities are rounded to
    bfloat16 whatever the model dtype, then promoted to the loaded
    cache's dtype for the products (``torch.einsum`` takes no mixed
    dtypes, so the promotion is written out).
    """
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = cache_k.shape[1]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, knew, vnew = _project(x, p, cfg, pos)
    cache_k[:, position] = _kv_store(knew[:, 0], cache_k.dtype)
    cache_v[:, position] = _kv_store(vnew[:, 0], cache_v.dtype)

    g = h // kv
    kc, vc = _kv_load(cache_k), _kv_load(cache_v)
    qg = q.reshape(b, kv, g, hd).to(torch.bfloat16)
    qg = qg.to(torch.promote_types(qg.dtype, kc.dtype))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kc) / math.sqrt(float(hd))
    idx = torch.arange(s, device=x.device)
    valid = idx <= position
    if window:
        valid &= idx > position - window
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    sink_cas = probs[..., 0].mean(dim=(1, 2))[:, None]      # (b, 1)
    probs = probs.to(torch.bfloat16)
    probs = probs.to(torch.promote_types(probs.dtype, vc.dtype))
    out = torch.einsum("bkgs,bskd->bkgd", probs, vc).to(x.dtype)
    out = torch.einsum("btk,kd->btd", out.reshape(b, 1, h * hd), p["wo"])
    return out, cache_k, cache_v, sink_cas


def decode_attention_slot(x, p, cfg: ArchConfig, cache_k, cache_v,
                          position: int, slot: int, window: int = 0):
    """Decode attention over a ring-buffer cache (hybrid SWA layers).

    The cache holds W slots; the new KV is written in place at ``slot``
    (position % W on an SWA layer, position on a global layer with
    W = max_seq).  RoPE is applied at write time, so slots are
    position-agnostic; validity comes from the absolute position window.
    No bfloat16 detour here: q and the probabilities stay in x's dtype.
    """
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = cache_k.shape[1]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, knew, vnew = _project(x, p, cfg, pos)
    cache_k[:, slot] = knew[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = vnew[:, 0].to(cache_v.dtype)

    # the absolute position each slot holds (ring arithmetic)
    idx = torch.arange(w, device=x.device)
    if window:
        # slot i holds the latest p with p % w == i and p <= position
        slot_pos = position - ((position - idx) % w)
    else:
        slot_pos = idx
    valid = (slot_pos >= 0) & (slot_pos <= position)
    if window:
        valid &= slot_pos > position - window

    g = h // kv
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cache_k) \
        / math.sqrt(float(hd))
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    # sink CAS: meaningful on global layers only (slot 0 holds position 0)
    sink_cas = probs[..., 0].mean(dim=(1, 2))[:, None]
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(x.dtype), cache_v)
    out = torch.einsum("btk,kd->btd", out.reshape(b, 1, h * hd), p["wo"])
    return out, cache_k, cache_v, sink_cas


# ----------------------------------------------------------------------------
# FFN (SwiGLU / GELU) + TIPS mixed-precision hook
# ----------------------------------------------------------------------------
def init_ffn_params(generator: torch.Generator, d_model: int, d_ff: int,
                    activation: str, dtype):
    dev = generator.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dtype)
    p = {"w_up": normal((d_model, d_ff), d_model ** -0.5),
         "w_down": normal((d_ff, d_model), d_ff ** -0.5)}
    if activation == "swiglu":
        p["w_gate"] = normal((d_model, d_ff), d_model ** -0.5)
    return p


def ffn(x, p, activation: str, tips_important=None):
    """(B, T, d) -> (B, T, d).

    ``tips_important``: bool (B, T); those rows keep INT12, the others
    fake-quantise to INT6 on the shared per-sample scale grid before the
    FFN matmuls (TIPS)."""
    if tips_important is not None:
        x = tips_mod.apply_precision_mask(x, tips_important)
    if activation == "swiglu":
        gate = torch.einsum("btd,df->btf", x, p["w_gate"])
        up = torch.einsum("btd,df->btf", x, p["w_up"])
        hmid = silu(gate) * up
    else:
        hmid = gelu(torch.einsum("btd,df->btf", x, p["w_up"]))
    return torch.einsum("btf,fd->btd", hmid, p["w_down"])


def tips_sink_mask(x, p_attn, cfg: ArchConfig, probs_sink):
    """Sink-token CAS -> importance mask (the LM generalisation of TIPS).
    probs_sink: (B, H, T), each query's attention to the sink token."""
    return probs_sink.mean(dim=1) < cfg.tips_threshold
