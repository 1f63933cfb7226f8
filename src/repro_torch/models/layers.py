"""Shared LM layers: the sharding context, norms, RoPE, GQA attention
(full-sequence, banded, decode over a linear or a ring-buffer cache), the
int8 KV grid, and the FFN with the TIPS hook (port of
``repro.models.layers``).

``ShardCtx`` carries a (data, model) mesh of ``launch.mesh`` through the
model.  The JAX package constrains activations with it and lets GSPMD
partition one program; here each rank runs its own shard and the
model-axis collectives are explicit (``models/parallel.py``).  A block
given ``ctx`` runs split: its weights are this rank's shard
(column-parallel ``wq/wk/wv/w_gate/w_up``, row-parallel ``wo/w_down``),
its input passes ``copy_to_tp`` and its output ``reduce_from_tp``.  It
runs split exactly where its layout (``attn_layout``, ``ffn_layout``)
splits its weights (``parallel.split_ctx``); one whose heads or width do
not divide the model axis runs replicated, the unsharded code on whole
weights, where GSPMD would pad.  The spec trees (``attn_param_specs``,
``ffn_param_specs``) are the JAX package's, as data.  Casts mirror the
JAX package's: projections and the P V product in the activation dtype,
the softmax in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import tips as tips_mod
from repro_torch.configs.base import ArchConfig
from repro_torch.models.parallel import (P, Split, copy_to_tp, mesh_shape,
                                         reduce_from_tp, split_ctx,
                                         tp_all_reduce)


# ----------------------------------------------------------------------------
# Sharding context
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh and the roles of its axes, carried through the model.

    ``tp_axis=None`` folds tensor parallelism away (TP-fold): model code
    keeps writing the literal "model" in its specs and ``spec`` rewrites it
    to replicated, while the physical model axis serves as extra data
    parallelism through ``dp_axes``.  Built on every rank of the mesh at
    once (a data group over several axes is a new process group, or WORLD
    where it spans the default group).  ``dp_axes`` over a multi-pod
    mesh's ("pod", "data") groups the ranks of one model index."""
    mesh: object                       # torch DeviceMesh, axes (data, model)
    dp_axes: tuple                     # ("data",) or ("data", "model")
    tp_axis: str | None = "model"

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                             f"{mesh_shape(self.mesh)}")
        shape = mesh_shape(self.mesh)
        dp_rank, dp_size = 0, 1
        for a in self.dp_axes:
            dp_rank = dp_rank * shape[a] + int(coord[names.index(a)])
            dp_size *= shape[a]
        if len(self.dp_axes) == 1:
            dp_group = self.mesh.get_group(self.dp_axes[0])
        else:
            dp_group = _axes_group(self.mesh, self.dp_axes)
        tp = self.tp_axis
        for k, v in (("dp_rank", dp_rank), ("dp_size", dp_size),
                     ("dp_group", dp_group),
                     ("tp_group", self.mesh.get_group(tp) if tp else None),
                     ("tp_rank", int(coord[names.index(tp)]) if tp else 0),
                     ("_tp_size", shape[tp] if tp else 1)):
            object.__setattr__(self, k, v)

    @property
    def tp_size(self) -> int:
        """Ranks on the model axis (1 under the TP-fold)."""
        return self._tp_size

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def spec(self, *spec) -> P:
        """``spec`` with the literal "model" rewritten to the model axis
        (to replicated under the TP-fold)."""
        return P(*(self.tp_axis if s == "model" else s for s in spec))

    def cs(self, x, *spec):
        """The JAX package's sharding constraint.  Here every rank already
        holds the shard its code computes, so ``x`` passes as it is; the
        spec is resolved and checked against the mesh's axes."""
        names = set(self.mesh.mesh_dim_names)
        for s in self.spec(*spec):
            for a in (s if isinstance(s, tuple) else (s,)):
                if a is not None and a not in names:
                    raise ValueError(f"cs: no mesh axis {a!r} in {names}")
        return x


def _axes_group(mesh, axes: tuple):
    """The process group of the ranks that share this rank's coordinates
    on every mesh axis not in ``axes`` (``axes`` in mesh order, so a
    rank's index in the group is its index over ``axes``, row-major).
    Every rank builds the group of each such coordinate, in the same
    order (``new_group`` is collective); one that spans the default group
    is WORLD."""
    names = tuple(mesh.mesh_dim_names)
    if [a for a in names if a in axes] != list(axes):
        raise ValueError(f"dp_axes {axes} are not axes of {names} in "
                         "mesh order")
    rest = [names.index(a) for a in names if a not in axes]
    grid = mesh.mesh.permute(rest + [names.index(a) for a in axes])
    rows = grid.reshape(-1, math.prod(mesh.size(names.index(a))
                                      for a in axes)).tolist()
    if len(rows) == 1 and rows[0] == list(range(dist.get_world_size())):
        return dist.group.WORLD
    me, mine = dist.get_rank(), None
    for row in rows:
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


def maybe_cs(ctx: Optional[ShardCtx], x, *spec):
    return ctx.cs(x, *spec) if ctx is not None else x


def sink_cas(probs_sink: torch.Tensor, cfg: ArchConfig, ctx):
    """The TIPS sink CAS: each query's attention to the sink averaged over
    ALL heads.  ``probs_sink`` holds this rank's heads in its dims 1 and 2;
    over a model axis of more than one rank the local sums are all-reduced
    before the division, so every rank builds the same TIPS mask.  There,
    with TIPS off, nothing reads it and it is not reduced: None."""
    if ctx is None or ctx.tp_size == 1:
        return probs_sink.mean(dim=(1, 2))
    if not cfg.tips:
        return None
    part = probs_sink.sum(dim=(1, 2)).detach()
    return tp_all_reduce(part, ctx.tp_group) / cfg.num_heads


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
def init_attn_params(generator: torch.Generator, cfg: ArchConfig, dtype,
                     device=None):
    """Random projections on ``device`` (the generator's by default), with
    the JAX package's shapes and scale."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    dev = generator.device if device is None else device

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * s).to(dtype)
    return {"wq": normal((d, h * hd)), "wk": normal((d, kv * hd)),
            "wv": normal((d, kv * hd)), "wo": normal((h * hd, d))}


def attn_param_specs(cfg: ArchConfig):
    """PartitionSpecs (without the stacked layer axis)."""
    return {"wq": P(None, "model"), "wk": P(None, "model"),
            "wv": P(None, "model"), "wo": P("model", None)}


def attn_layout(cfg: ArchConfig, tp: int):
    """How ``init_attn_params``' leaves split (None: replicated): by
    heads where both head counts divide the model axis."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        return {k: None for k in ("wq", "wk", "wv", "wo")}
    return {"wq": Split(1), "wk": Split(1), "wv": Split(1), "wo": Split(0)}


def _causal_mask(tq, tk, offset=0, device=None):
    q = torch.arange(tq, device=device)[:, None] + offset
    k = torch.arange(tk, device=device)[None, :]
    return q >= k


def _window_mask(tq, tk, window, offset=0, device=None):
    q = torch.arange(tq, device=device)[:, None] + offset
    k = torch.arange(tk, device=device)[None, :]
    return (q >= k) & (q - k < window)


def _project(x, p, cfg: ArchConfig, positions):
    """q (B, T, H, hd), k and v (B, T, KV, hd); RoPE on q and k.  H and KV
    are the heads ``p`` holds (this rank's, under a split ``ctx``)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h, kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q = torch.einsum("btd,dk->btk", x, p["wq"]).reshape(b, t, h, hd)
    k = torch.einsum("btd,dk->btk", x, p["wk"]).reshape(b, t, kv, hd)
    v = torch.einsum("btd,dk->btk", x, p["wv"]).reshape(b, t, kv, hd)
    # RoPE on q and k from one table (as two apply_rope calls would give)
    tables = _rope_tables(positions, hd, cfg.rotary_pct, cfg.rope_theta)
    return _rotate(q, *tables), _rotate(k, *tables), v


def gqa_attention(x, p, cfg: ArchConfig, positions, window: int = 0,
                  prune_threshold: float = 0.0, q_chunk: int = 1024,
                  global_flag: bool | None = None, *,
                  ctx: Optional[ShardCtx] = None):
    """Full-sequence causal GQA attention.  (B, T, d) -> (out (B, T, d),
    sink CAS (B, T) float32, (k, v)).

    ``prune_threshold`` > 0 applies PSSA step-1 pruning to the
    post-softmax scores.  ``window`` > 0 bands the mask; with
    ``global_flag`` given (a hybrid layer) the band applies only where the
    flag is False.  For T > q_chunk (T a multiple of it) the score block
    runs over query chunks, so at most (B, H, q_chunk, T) scores exist at
    a time.  Grouped-query einsums: KV is never repeated to full heads.
    Where ``attn_layout`` splits, ``p`` holds this rank's heads, k
    and v are this rank's, and the sink CAS averages over all heads.
    """
    b, t, _ = x.shape
    hd = cfg.head_dim
    ctx = split_ctx(ctx, attn_layout, cfg)
    q, k, v = _project(copy_to_tp(x, ctx), p, cfg, positions)
    h, kv = q.shape[2], k.shape[2]
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
        # token (averaged over heads below)
        ob = torch.einsum("bkgts,bskd->btkgd", probs.to(x.dtype), v)
        return ob.reshape(b, qc, h * hd), probs[..., 0]

    if t > q_chunk and t % q_chunk == 0:
        outs, sinks = zip(*(block(q[:, i:i + q_chunk], i)
                            for i in range(0, t, q_chunk)))
        out, sink = torch.cat(outs, dim=1), torch.cat(sinks, dim=-1)
    else:
        out, sink = block(q, 0)
    cas = sink_cas(sink, cfg, ctx)                           # (b, t)
    out = torch.einsum("btk,kd->btd", out, p["wo"])
    return reduce_from_tp(out, ctx), cas, (k, v)


def swa_attention_chunked(x, p, cfg: ArchConfig, positions, window: int,
                          *, ctx: Optional[ShardCtx] = None):
    """Banded (sliding-window) attention, sub-quadratic: queries are
    chunked at ``window`` and each chunk attends to itself and the
    previous chunk under the band mask.  No sink CAS (the sink leaves the
    band).  ``ctx`` as in ``gqa_attention``."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    if t % window:
        raise ValueError(f"swa_attention_chunked: window {window} does not "
                         f"divide T={t}")
    nc = t // window
    ctx = split_ctx(ctx, attn_layout, cfg)
    q, k, v = _project(copy_to_tp(x, ctx), p, cfg, positions)
    h, kv = q.shape[2], k.shape[2]
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
    return reduce_from_tp(torch.einsum("btk,kd->btd", out, p["wo"]), ctx)


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
                     window: int = 0, *, ctx: Optional[ShardCtx] = None):
    """Single-token decode with a KV cache.

    x: (B, 1, d); cache_k/v: (B, S, kv, hd); ``position``: the same for
    every row (the serving batch is position-aligned).  The new key and
    value are written into the caches in place (the JAX serve loop
    donates its cache buffers).  Returns (out (B, 1, d), cache_k, cache_v,
    sink CAS (B, 1)).

    As in the JAX package, q and the probabilities are rounded to
    bfloat16 whatever the model dtype, then promoted to the loaded
    cache's dtype for the products (``torch.einsum`` takes no mixed
    dtypes, so the promotion is written out).  Under a split ``ctx`` the
    caches hold this rank's kv heads.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    s = cache_k.shape[1]
    ctx = split_ctx(ctx, attn_layout, cfg)
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, knew, vnew = _project(copy_to_tp(x, ctx), p, cfg, pos)
    h, kv = q.shape[2], knew.shape[2]
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
    cas = sink_cas(probs[..., 0], cfg, ctx)
    cas = None if cas is None else cas[:, None]             # (b, 1)
    probs = probs.to(torch.bfloat16)
    probs = probs.to(torch.promote_types(probs.dtype, vc.dtype))
    out = torch.einsum("bkgs,bskd->bkgd", probs, vc).to(x.dtype)
    out = torch.einsum("btk,kd->btd", out.reshape(b, 1, h * hd), p["wo"])
    return reduce_from_tp(out, ctx), cache_k, cache_v, cas


def decode_attention_slot(x, p, cfg: ArchConfig, cache_k, cache_v,
                          position: int, slot: int, window: int = 0, *,
                          ctx: Optional[ShardCtx] = None):
    """Decode attention over a ring-buffer cache (hybrid SWA layers).

    The cache holds W slots; the new KV is written in place at ``slot``
    (position % W on an SWA layer, position on a global layer with
    W = max_seq).  RoPE is applied at write time, so slots are
    position-agnostic; validity comes from the absolute position window.
    No bfloat16 detour here: q and the probabilities stay in x's dtype.
    ``ctx`` as in ``decode_attention``.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    w = cache_k.shape[1]
    ctx = split_ctx(ctx, attn_layout, cfg)
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, knew, vnew = _project(copy_to_tp(x, ctx), p, cfg, pos)
    h, kv = q.shape[2], knew.shape[2]
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
    cas = sink_cas(probs[..., 0], cfg, ctx)
    cas = None if cas is None else cas[:, None]
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(x.dtype), cache_v)
    out = torch.einsum("btk,kd->btd", out.reshape(b, 1, h * hd), p["wo"])
    return reduce_from_tp(out, ctx), cache_k, cache_v, cas


# ----------------------------------------------------------------------------
# FFN (SwiGLU / GELU) + TIPS mixed-precision hook
# ----------------------------------------------------------------------------
def init_ffn_params(generator: torch.Generator, d_model: int, d_ff: int,
                    activation: str, dtype, device=None):
    dev = generator.device if device is None else device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dtype)
    p = {"w_up": normal((d_model, d_ff), d_model ** -0.5),
         "w_down": normal((d_ff, d_model), d_ff ** -0.5)}
    if activation == "swiglu":
        p["w_gate"] = normal((d_model, d_ff), d_model ** -0.5)
    return p


def ffn_param_specs(activation: str):
    p = {"w_up": P(None, "model"), "w_down": P("model", None)}
    if activation == "swiglu":
        p["w_gate"] = P(None, "model")
    return p


def ffn_layout(d_ff: int, activation: str, tp: int):
    """How ``init_ffn_params``' leaves split (None: replicated)."""
    ok = d_ff % tp == 0
    p = {"w_up": Split(1) if ok else None, "w_down": Split(0) if ok else None}
    if activation == "swiglu":
        p["w_gate"] = Split(1) if ok else None
    return p


def ffn(x, p, activation: str, tips_important=None, *,
        ctx: Optional[ShardCtx] = None):
    """(B, T, d) -> (B, T, d).

    ``tips_important``: bool (B, T); those rows keep INT12, the others
    fake-quantise to INT6 on the shared per-sample scale grid before the
    FFN matmuls (TIPS).  ``ctx``: the FFN runs split, ``p`` holding this
    rank's columns of ``w_gate`` / ``w_up`` and rows of ``w_down`` (the
    caller passes ``split_ctx(ctx, ffn_layout, d_ff, activation)``)."""
    if tips_important is not None:
        x = tips_mod.apply_precision_mask(x, tips_important)
    x = copy_to_tp(x, ctx)
    if activation == "swiglu":
        gate = torch.einsum("btd,df->btf", x, p["w_gate"])
        up = torch.einsum("btd,df->btf", x, p["w_up"])
        hmid = silu(gate) * up
    else:
        hmid = gelu(torch.einsum("btd,df->btf", x, p["w_up"]))
    return reduce_from_tp(torch.einsum("btf,fd->btd", hmid, p["w_down"]),
                          ctx)


def tips_sink_mask(x, p_attn, cfg: ArchConfig, probs_sink):
    """Sink-token CAS -> importance mask (the LM generalisation of TIPS).
    probs_sink: (B, H, T), each query's attention to the sink token."""
    return probs_sink.mean(dim=1) < cfg.tips_threshold
