"""BK-SDM-Tiny UNet with PSSA / TIPS / DBSC (port of
``repro.diffusion.unet``: the dense path, temporal patch reuse and the
denoiser-contract hooks; registered as family ``"unet"``).

SD-v1 block layout with one resnet + one transformer block per down stage,
two per up stage and no mid block.  Each transformer block runs PSSA
self-attention, cross-attention that emits the TIPS CLS score, and a GEGLU
FFN whose rows run INT12/INT6 per the TIPS mask; every stage goes through
``repro_torch.kernels.dispatch``.  With a ``ReuseCache`` and an enabled
``UNetConfig.reuse_policy`` each block recomputes only the patches whose
input changed (``repro_torch.core.reuse``).  Slot serving asks for per-row
counters (``row_stats`` -> ``SlotStats``) and passes phase-scheduled
per-row threshold scales (``overrides``, a ``solvers.PhaseOverrides``).
``_transformer_block`` is also the DiT family's block
(``repro_torch.diffusion.dit``), which conditions it on the timestep
through the ``modulation`` hook.

Layouts: activations are NHWC at the public functions, as in the JAX
package.  Parameters are a nested dict in the JAX layout with one change:
conv weights are OIHW (PyTorch's), converted once
(``repro_torch.convert``); linear weights stay (in, out), applied as
``x @ w``.  Convolutions run on an NCHW view of the NHWC tensor
(channels-last memory), so no copy is made either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.reuse import (LayerReuseCache, ReuseCache, ReusePolicy,
                                    ReuseRowCounters, window_patch_mask)
from repro_torch.diffusion.stats import (LayerKey, SlotStats, UNetStats,
                                         attn_layer_order)
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.runtime import resolve_device
from repro_torch.kernels.patch_reuse import ops as reuse_ops


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple = (320, 640, 1280, 1280)
    down_attn: tuple = (True, True, True, False)
    resnets_per_down: int = 1          # BK-SDM-Tiny: 1 (base SD: 2)
    resnets_per_up: int = 2            # BK-SDM-Tiny: 2 (base SD: 3)
    has_mid_block: bool = False        # removed in BK-SDM-Small/Tiny
    transformer_depth: int = 1
    num_heads: int = 8
    context_dim: int = 768             # CLIP ViT-L/14 text width
    text_len: int = 77
    time_dim: int = 1280
    latent_size: int = 64              # 512x512 images -> 64x64x4 latents
    groups: int = 32
    ffn_mult: int = 4                  # GEGLU hidden = 4 * channels

    # --- paper features ---
    pssa: bool = True
    tips: bool = True
    pssa_threshold: float = 1.0 / 8192.0
    # route PSSA accounting through the materializing seed oracle
    pssa_stats_reference: bool = False
    kernel_policy: KernelPolicy = KernelPolicy()
    precision: PrecisionPolicy = PrecisionPolicy()
    # temporal patch reuse (repro_torch.core.reuse); off by default
    reuse_policy: ReusePolicy = ReusePolicy()

    def patch_size(self, resolution: int) -> int:
        """PSXU patch width at a given feature-map resolution (16/32/64)."""
        return min(64, max(16, resolution))

    def smoke(self) -> "UNetConfig":
        """Reduced config that runs a full forward pass on a CPU in seconds."""
        return dataclasses.replace(
            self, block_channels=(32, 64, 64, 64), num_heads=4,
            context_dim=32, text_len=8, time_dim=64, latent_size=16,
            groups=8)

    def full_geometry(self) -> "UNetConfig":
        """The full-size config: the analytic ledger's target."""
        return UNetConfig()

    def attn_resolutions(self) -> tuple:
        """Distinct attention resolutions, sorted descending."""
        return tuple(sorted({self.latent_size >> s
                             for s, a in enumerate(self.down_attn) if a},
                            reverse=True))

    # --- denoiser-contract hooks (repro_torch.diffusion.denoiser) ---
    def layer_order(self) -> tuple:
        """The stats layer order of this config (``stats.LayerKey``s), as
        ``unet_forward`` visits the blocks: down stages, optional mid
        block, up stages."""
        order = []
        nstages = len(self.block_channels)
        for i, has_attn in enumerate(self.down_attn):
            if not has_attn:
                continue
            for r in range(self.resnets_per_down):
                order.append(LayerKey(f"down{i}.{r}", self.latent_size >> i))
        if self.has_mid_block:
            order.append(LayerKey("mid", self.latent_size >> (nstages - 1)))
        for j, i in enumerate(reversed(range(nstages))):
            if not self.down_attn[i]:
                continue
            for r in range(self.resnets_per_up):
                order.append(LayerKey(f"up{j}.{r}", self.latent_size >> i))
        return tuple(order)

    def channels_at(self, resolution: int) -> int:
        """Token width of the transformer blocks at ``resolution``."""
        stage = (self.latent_size // resolution).bit_length() - 1
        return self.block_channels[stage]

    @property
    def num_down_attn_layers(self) -> int:
        """Transformer blocks on the down path."""
        return sum(self.resnets_per_down * self.transformer_depth
                   for a in self.down_attn if a)


BK_SDM_TINY = UNetConfig()


# ----------------------------------------------------------------------------
# Primitive layers
# ----------------------------------------------------------------------------
def conv2d(x, w, b=None, stride: int = 1, padding: int = 1):
    """NHWC activations, OIHW weights -> NHWC."""
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
    """Sinusoidal (B,) int timesteps -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def upsample_nearest2x(x):
    """Exact 2x nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ----------------------------------------------------------------------------
# Parameter init (same shapes and distributions as the JAX package)
# ----------------------------------------------------------------------------
class _Init:
    def __init__(self, generator, device):
        self.g, self.device = generator, device

    def uniform(self, shape, s):
        return torch.empty(shape, device=self.device).uniform_(
            -s, s, generator=self.g)

    def conv(self, kh, kw, cin, cout):
        return {"w": self.uniform((cout, cin, kh, kw),
                                  1.0 / math.sqrt(kh * kw * cin)),
                "b": torch.zeros(cout, device=self.device)}

    def lin(self, cin, cout, bias=True):
        p = {"w": self.uniform((cin, cout), 1.0 / math.sqrt(cin))}
        if bias:
            p["b"] = torch.zeros(cout, device=self.device)
        return p

    def norm(self, c):
        return {"scale": torch.ones(c, device=self.device),
                "bias": torch.zeros(c, device=self.device)}


def _resnet_p(ini: _Init, cin, cout, tdim):
    p = {"norm1": ini.norm(cin), "conv1": ini.conv(3, 3, cin, cout),
         "time": ini.lin(tdim, cout), "norm2": ini.norm(cout),
         "conv2": ini.conv(3, 3, cout, cout)}
    if cin != cout:
        p["skip"] = ini.conv(1, 1, cin, cout)
    return p


def _transformer_p(ini: _Init, c, cfg: UNetConfig):
    dff = cfg.ffn_mult * c
    return {
        "norm_in": ini.norm(c), "proj_in": ini.lin(c, c),
        "ln1": ini.norm(c),
        "sa_q": ini.lin(c, c, bias=False), "sa_k": ini.lin(c, c, bias=False),
        "sa_v": ini.lin(c, c, bias=False), "sa_o": ini.lin(c, c),
        "ln2": ini.norm(c),
        "ca_q": ini.lin(c, c, bias=False),
        "ca_k": ini.lin(cfg.context_dim, c, bias=False),
        "ca_v": ini.lin(cfg.context_dim, c, bias=False),
        "ca_o": ini.lin(c, c),
        "ln3": ini.norm(c),
        "ff_geglu": ini.lin(c, 2 * dff), "ff_out": ini.lin(dff, c),
        "proj_out": ini.lin(c, c),
    }


def init_unet_params(cfg: UNetConfig, generator=None, device=None):
    """Random parameters on ``device`` (``None``: the card)."""
    ini = _Init(generator, resolve_device(device))
    chans = cfg.block_channels
    p = {"time_mlp1": ini.lin(chans[0], cfg.time_dim),
         "time_mlp2": ini.lin(cfg.time_dim, cfg.time_dim),
         "conv_in": ini.conv(3, 3, cfg.in_channels, chans[0])}
    down, skip_channels, cin = [], [chans[0]], chans[0]
    for i, cout in enumerate(chans):
        stage = {"resnets": [], "attns": []}
        for _ in range(cfg.resnets_per_down):
            stage["resnets"].append(_resnet_p(ini, cin, cout, cfg.time_dim))
            if cfg.down_attn[i]:
                stage["attns"].append(_transformer_p(ini, cout, cfg))
            cin = cout
            skip_channels.append(cout)
        if i < len(chans) - 1:
            stage["down"] = ini.conv(3, 3, cout, cout)
            skip_channels.append(cout)
        down.append(stage)
    p["down"] = down
    if cfg.has_mid_block:
        c = chans[-1]
        p["mid"] = {"res1": _resnet_p(ini, c, c, cfg.time_dim),
                    "attn": _transformer_p(ini, c, cfg),
                    "res2": _resnet_p(ini, c, c, cfg.time_dim)}
    up, cin = [], chans[-1]
    for j, i in enumerate(reversed(range(len(chans)))):
        cout = chans[i]
        stage = {"resnets": [], "attns": []}
        for _ in range(cfg.resnets_per_up):
            skip_c = skip_channels.pop()
            stage["resnets"].append(
                _resnet_p(ini, cin + skip_c, cout, cfg.time_dim))
            if cfg.down_attn[i]:
                stage["attns"].append(_transformer_p(ini, cout, cfg))
            cin = cout
        if j < len(chans) - 1:
            stage["up"] = ini.conv(3, 3, cout, cout)
        up.append(stage)
    p["up"] = up
    p["norm_out"] = ini.norm(chans[0])
    p["conv_out"] = ini.conv(3, 3, chans[0], cfg.out_channels)
    return p


# ----------------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------------
def _resnet(x, p, temb, groups):
    h = group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    t = F.silu(temb) @ p["time"]["w"] + p["time"]["b"]
    h = h + t[:, None, None, :]
    h = group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    skip = x if "skip" not in p else conv2d(x, p["skip"]["w"],
                                            p["skip"]["b"], padding=0)
    return skip + h


def _attn_heads(x, w, heads):
    b, t, _ = x.shape
    return (x @ w).reshape(b, t, heads, -1).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _reuse_plan(x2d, reuse, cfg: UNetConfig, policy: KernelPolicy,
                stats_rows, reuse_scale=None):
    """The reuse branch's plan for one block: (token rows (B, R), gate
    per row (B, R), ReuseRowCounters, token input (B, T, C)).

    ``reuse_scale`` ((B,) or None) scales the threshold per row: the
    patch delta then runs at threshold 0 (the same values) and is
    compared with ``threshold * scale`` here."""
    rp, cache, valid = reuse
    b, res, wid, c = x2d.shape
    tokens_in = x2d.reshape(b, res * wid, c)
    patch = cfg.patch_size(res)
    if rp.apriori_window is not None:
        # the edit region is known up front: no patch-delta launch
        mask = window_patch_mask(rp.apriori_window, res, patch,
                                 cfg.latent_size)
        changed = torch.tensor(mask, dtype=torch.bool,
                               device=x2d.device)[None].expand(b, -1)
    elif reuse_scale is not None:
        delta, _ = dispatch.patch_delta(policy, tokens_in, cache.ref,
                                        patch=patch, threshold=0.0)
        changed = delta >= (rp.threshold * reuse_scale)[:, None]
    else:
        _, changed = dispatch.patch_delta(policy, tokens_in, cache.ref,
                                          patch=patch,
                                          threshold=rp.threshold)
    if valid.shape[0] != b:
        # post-dup rows are [cond | uncond]; validity is per request row
        valid = torch.cat([valid, valid], dim=0)
    act = torch.logical_or(changed, torch.logical_not(valid)[:, None])
    npatch = tokens_in.shape[1] // patch
    order, gate = reuse_ops.reuse_plan(act, rp.cap_patches(npatch))
    rows = reuse_ops.plan_token_rows(order, patch)
    gate_rows = gate.repeat_interleave(patch, dim=1)
    sr = b if stats_rows is None else stats_rows
    counters = ReuseRowCounters(
        computed=gate.sum(dim=1, dtype=torch.int32)[:sr],
        total=torch.full((b,), npatch, dtype=torch.int32,
                         device=x2d.device)[:sr])
    return rows, gate_rows, counters, tokens_in


_STAGES = {"sa": 0, "ca": 1, "ffn": 2}    # modulation triples, in order


def _transformer_block(x2d, p, context, cfg: UNetConfig, tips_active,
                       stats_rows=None, dup_after_self: bool = False,
                       policy: KernelPolicy | None = None,
                       precision: PrecisionPolicy | None = None,
                       reuse=None, row_stats: bool = False, overrides=None,
                       modulation=None):
    """x2d: (B, H, W, C) -> (out, PSSAStats, TIPSResult, reuse_out).

    ``tips_active``: a bool or a (B,) per-row bool tensor.  ``stats_rows``
    restricts the stats to the first N batch rows; ``row_stats`` reports
    per-row integer counters instead of folded stats.  ``dup_after_self``:
    under fused CFG the cond and uncond halves agree up to the first
    cross-attention, so everything through this block's self-attention
    runs on the cond half and the hidden state is tiled to both halves
    here (``x2d`` then has half as many rows as ``context``).

    ``reuse``: None (the dense path; ``reuse_out`` is None) or a
    ``(ReusePolicy, LayerReuseCache, valid)`` triple.  The block then
    gathers the rows of the active patches into the self-attention
    queries, the cross-attention queries and the FFN (K/V, norms and
    projections stay dense), scatters the stage outputs over the cached
    ones, and returns ``reuse_out = (new LayerReuseCache,
    ReuseRowCounters)``.  At threshold 0 the plan is the identity and the
    block is bit-identical to the dense path (DESIGN.md §9).

    ``overrides`` (a ``solvers.PhaseOverrides`` or None) carries per-row
    threshold SCALES for the request rows, tiled to [cond | uncond] where
    the hidden state is; a lane the bank never schedules is None, which
    leaves the block's ops and kernel routing exactly as without it.
    The ``reuse_scale`` lane scales each row's reuse threshold.

    ``modulation`` (the DiT family's adaLN; None for the UNet): nine
    (B, 1, C) vectors, (shift, scale, gate) for the self-attention, the
    cross-attention and the FFN in that order.  After each stage's layer
    norm the hidden state becomes ``hn * (1 + scale) + shift``, and the
    stage's output is multiplied by ``gate`` before the residual add (and
    before the reuse scatter, so the cache holds gated outputs).  They
    carry request rows and are tiled to [cond | uncond] as the override
    lanes are.
    """
    b, hgt, wid, c = x2d.shape
    heads = cfg.num_heads
    policy = cfg.kernel_policy if policy is None else policy
    precision = cfg.precision if precision is None else precision

    def per_rows(vec, nrows):
        # override lanes are per REQUEST row; tile to [cond | uncond]
        if vec is not None and vec.shape[0] != nrows:
            vec = torch.cat([vec, vec], dim=0)
        return vec

    def gather(x):
        return x if reuse is None else reuse_ops.gather_rows(x, rows)

    def stage_out(stage, x):
        # DiT gates the stage; under reuse the result goes over the cache
        if modulation is not None:
            x = x * per_rows(modulation[3 * _STAGES[stage] + 2], x.shape[0])
        if reuse is None:
            return x
        return reuse_ops.scatter_rows(getattr(reuse[1], stage), rows, x,
                                      gate_rows)

    def modulate(stage, hn):
        if modulation is None:
            return hn
        i = 3 * _STAGES[stage]
        return (hn * (1.0 + per_rows(modulation[i + 1], hn.shape[0]))
                + per_rows(modulation[i], hn.shape[0]))

    if reuse is not None:
        reuse_scale = (None if overrides is None
                       else per_rows(overrides.reuse_scale, b))
        rows, gate_rows, counters, tokens_in = _reuse_plan(
            x2d, reuse, cfg, policy, stats_rows, reuse_scale)

    h = group_norm(x2d, p["norm_in"]["scale"], p["norm_in"]["bias"],
                   cfg.groups).reshape(b, hgt * wid, c)
    h = h @ p["proj_in"]["w"] + p["proj_in"]["b"]

    # --- self-attention (PSSA); under reuse the queries are gathered to
    # the active patch rows and K/V stay dense ---
    resid = h
    hn = modulate("sa", layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"]))
    q = _attn_heads(gather(hn), p["sa_q"]["w"], heads)
    k = _attn_heads(hn, p["sa_k"]["w"], heads)
    v = _attn_heads(hn, p["sa_v"]["w"], heads)
    sa_threshold = cfg.pssa_threshold
    if overrides is not None and overrides.pssa_scale is not None:
        # a (B,) threshold: dispatch takes the reference route
        sa_threshold = cfg.pssa_threshold * per_rows(overrides.pssa_scale,
                                                     q.shape[0])
    sa = dispatch.self_attention(policy, q, k, v, patch=cfg.patch_size(hgt),
                                 threshold=sa_threshold,
                                 prune_scores=cfg.pssa,
                                 stats_rows=None if dup_after_self
                                 else stats_rows,
                                 reference_stats=cfg.pssa_stats_reference,
                                 row_stats=row_stats)
    sa_full = stage_out("sa", _merge_heads(sa.out) @ p["sa_o"]["w"]
                      + p["sa_o"]["b"])
    h = resid + sa_full

    if dup_after_self:
        # tile [cond] -> [cond | uncond]; divergence starts at cross-attn
        h = torch.cat([h, h], dim=0)
        x2d = torch.cat([x2d, x2d], dim=0)
        b = x2d.shape[0]
        if reuse is not None:
            # the plan was made on the cond half; both halves share it
            rows = torch.cat([rows, rows], dim=0)
            gate_rows = torch.cat([gate_rows, gate_rows], dim=0)

    # --- cross-attention (TIPS CAS source) ---
    resid = h
    hn = modulate("ca", layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"]))
    q = _attn_heads(gather(hn), p["ca_q"]["w"], heads)
    kt = _attn_heads(context, p["ca_k"]["w"], heads)
    vt = _attn_heads(context, p["ca_v"]["w"], heads)
    tips_scale = (None if overrides is None
                  else per_rows(overrides.tips_scale, h.shape[0]))
    ca = dispatch.cross_attention(policy, q, kt, vt, precision=precision,
                                  stats_rows=stats_rows, row_stats=row_stats,
                                  threshold_scale=tips_scale)
    ca_full = stage_out("ca", _merge_heads(ca.out) @ p["ca_o"]["w"]
                      + p["ca_o"]["b"])
    h = resid + ca_full

    # --- FFN (GEGLU) with TIPS mixed precision ---
    resid = h
    hn = modulate("ffn", layer_norm(h, p["ln3"]["scale"],
                                    p["ln3"]["bias"]))
    important = None
    if cfg.tips:
        active = torch.as_tensor(tips_active, device=h.device)
        if active.ndim == 1:
            # per-row activity; rows doubled at the cross-attn under cfg_dup
            if active.shape[0] != b:
                active = torch.cat([active, active], dim=0)
            active = active[:, None]
        # under reuse ca.important_full lives on the gathered rows
        important = torch.logical_or(ca.important_full,
                                     torch.logical_not(active))
    ffn_full = stage_out("ffn", dispatch.ffn_geglu(policy, gather(hn), p,
                                                 important,
                                                 precision=precision))
    h = resid + ffn_full

    h = h @ p["proj_out"]["w"] + p["proj_out"]["b"]
    out = x2d + h.reshape(b, hgt, wid, c)
    if reuse is None:
        return out, sa.stats, ca.tips_result, None
    new_cache = LayerReuseCache(ref=tokens_in, sa=sa_full, ca=ca_full,
                                ffn=ffn_full)
    return out, sa.stats, ca.tips_result, (new_cache, counters)


def _downsample(x, p):
    return conv2d(x, p["w"], p["b"], stride=2)


def _upsample(x, p):
    return conv2d(upsample_nearest2x(x), p["w"], p["b"])


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------
def unet_forward(params, latents, timesteps, context, cfg: UNetConfig,
                 tips_active=True, stats_rows: Optional[int] = None,
                 cfg_dup: bool = False,
                 reuse_cache: Optional[ReuseCache] = None,
                 row_stats: bool = False, overrides=None):
    """latents (B, S, S, 4), timesteps (B,), context (B, Ttext, ctx_dim).

    Returns (eps (B, S, S, 4), ``UNetStats``), or a ``SlotStats`` of
    per-row integer counters under ``row_stats`` (slot serving, rows at
    different denoising steps).  ``overrides`` (a
    ``solvers.PhaseOverrides``) threads per-row threshold scales to every
    transformer block; None leaves every block as it was.  ``cfg_dup``: ``latents`` and
    ``timesteps`` carry only the cond half (B rows) while ``context``
    carries ``[cond | uncond]`` (2B rows); the shared prefix runs once and
    ``eps`` comes back with 2B rows.

    ``reuse_cache`` (a ``ReuseCache`` for this batch and CFG geometry)
    switches temporal patch reuse on when ``cfg.reuse_policy.enabled``.
    The return then gains a third element, the NEW cache (this step's
    activations, every row valid), and ``stats.reuse`` holds per-layer
    ``ReuseRowCounters``.
    """
    pssa_stats: list = []
    tips_stats: list = []
    reuse_stats: list = []
    new_layer_caches: list = []
    reuse_on = cfg.reuse_policy.enabled and reuse_cache is not None
    needs_dup = cfg_dup
    if cfg_dup and context.shape[0] != 2 * latents.shape[0]:
        raise ValueError(f"cfg_dup needs 2x context rows: context "
                         f"{tuple(context.shape)}, latents "
                         f"{tuple(latents.shape)}")

    temb = timestep_embedding(timesteps, cfg.block_channels[0])
    temb = temb @ params["time_mlp1"]["w"] + params["time_mlp1"]["b"]
    temb = F.silu(temb) @ params["time_mlp2"]["w"] + params["time_mlp2"]["b"]

    def attn_block(h, bp):
        nonlocal temb, needs_dup
        reuse = None
        if reuse_on:
            reuse = (cfg.reuse_policy, reuse_cache.layers[len(pssa_stats)],
                     reuse_cache.valid)
        h, sa, ca, ru = _transformer_block(h, bp, context, cfg, tips_active,
                                           stats_rows,
                                           dup_after_self=needs_dup,
                                           reuse=reuse, row_stats=row_stats,
                                           overrides=overrides)
        if needs_dup:
            temb = torch.cat([temb, temb], dim=0)
            needs_dup = False
        pssa_stats.append(sa)
        tips_stats.append(ca)
        if reuse_on:
            new_layer_caches.append(ru[0])
            reuse_stats.append(ru[1])
        return h

    def pop_skip(h):
        skip = skips.pop()
        if skip.shape[0] != h.shape[0]:   # recorded before duplication
            skip = torch.cat([skip, skip], dim=0)
        return skip

    h = conv2d(latents, params["conv_in"]["w"], params["conv_in"]["b"])
    skips = [h]
    for stage in params["down"]:
        for r, rp in enumerate(stage["resnets"]):
            h = _resnet(h, rp, temb, cfg.groups)
            if stage["attns"]:
                h = attn_block(h, stage["attns"][r])
            skips.append(h)
        if "down" in stage:
            h = _downsample(h, stage["down"])
            skips.append(h)

    if cfg.has_mid_block:
        mp = params["mid"]
        h = _resnet(h, mp["res1"], temb, cfg.groups)
        h = attn_block(h, mp["attn"])
        h = _resnet(h, mp["res2"], temb, cfg.groups)

    for stage in params["up"]:
        for r, rp in enumerate(stage["resnets"]):
            h = _resnet(torch.cat([h, pop_skip(h)], dim=-1), rp, temb,
                        cfg.groups)
            if stage["attns"]:
                h = attn_block(h, stage["attns"][r])
        if "up" in stage:
            h = _upsample(h, stage["up"])

    if needs_dup:                     # no cross-attention anywhere: tile eps
        h = torch.cat([h, h], dim=0)

    h = group_norm(h, params["norm_out"]["scale"],
                   params["norm_out"]["bias"], cfg.groups)
    eps = conv2d(F.silu(h), params["conv_out"]["w"], params["conv_out"]["b"])
    stats_cls = SlotStats if row_stats else UNetStats
    stats = stats_cls.from_layer_list(attn_layer_order(cfg), pssa_stats,
                                      tips_stats, reuse=reuse_stats)
    if reuse_on:
        new_cache = ReuseCache(valid=torch.ones_like(reuse_cache.valid),
                               layers=tuple(new_layer_caches))
        return eps, stats, new_cache
    return eps, stats


def abstract_unet_params(cfg: UNetConfig):
    """The parameter tree's shapes and dtypes, on the meta device (no
    storage allocated)."""
    return init_unet_params(cfg, None, "meta")


# --- denoiser-contract registration (repro_torch.diffusion.denoiser) ---
from repro_torch.diffusion import denoiser as _denoiser  # noqa: E402

_denoiser.register_family(_denoiser.FamilySpec(
    family="unet", config_cls=UNetConfig, init_params=init_unet_params,
    forward=unet_forward, abstract_params=abstract_unet_params))
