"""DiT denoiser: patchify -> N adaLN transformer blocks -> unpatchify (port
of ``repro.diffusion.dit``; registered as family ``"dit"``).

The second model family behind the denoiser contract
(``repro_torch.diffusion.denoiser``): a diffusion transformer in the DiT-S
shape (Peebles & Xie, 2023) with cross-attention text conditioning.  Each
block IS ``unet._transformer_block``, conditioned on the timestep through
its ``modulation`` hook, so PSSA self-attention, TIPS cross-attention and
the DBSC FFN go through the same ``kernels.dispatch`` table as the UNet's,
and the engine's slots, solver banks, temporal reuse and ledger serve DiT
with no change.

Geometry: latents (B, S, S, C) are patchified with stride ``patch`` into a
(S/patch)-sided token grid kept 2-D, (B, g, g, D): the feature-map shape
``_transformer_block`` and the patch-reuse ops take.  One token
resolution for the whole network, so ``layer_order()`` is ``block{i}@g``.

adaLN: per block, ``silu(temb)`` goes through a per-block linear to 9
vectors, (shift, scale, gate) for the self-attention, cross-attention and
FFN stages.  They are random like every other projection (DiT zero-inits
them for training; zero gates would switch the stages out of eps).  The
final layer applies (shift, scale) to the last norm, projects to patch
pixels and unpatchifies.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.reuse import ReuseCache, ReusePolicy
from repro_torch.diffusion.stats import (LayerKey, SlotStats, UNetStats,
                                         attn_layer_order)
from repro_torch.diffusion.unet import (_Init, _transformer_block,
                                        _transformer_p, layer_norm,
                                        timestep_embedding)
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """DiT-S/2-shaped text-conditioned diffusion transformer."""
    in_channels: int = 4
    out_channels: int = 4
    latent_size: int = 32              # 256x256 images -> 32x32x4 latents
    patch: int = 2                     # patchify stride (DiT-S/2)
    hidden_size: int = 384             # DiT-S width
    depth: int = 12                    # DiT-S depth
    num_heads: int = 6                 # DiT-S heads
    context_dim: int = 768             # CLIP ViT-L/14 text width
    text_len: int = 77
    time_dim: int = 384
    groups: int = 32                   # block entry GroupNorm (gcd'd)
    ffn_mult: int = 4                  # GEGLU hidden = 4 * hidden_size

    # --- paper features (the same toggles and policies as UNetConfig) ---
    pssa: bool = True
    tips: bool = True
    pssa_threshold: float = 1.0 / 8192.0
    pssa_stats_reference: bool = False
    kernel_policy: KernelPolicy = KernelPolicy()
    precision: PrecisionPolicy = PrecisionPolicy()
    reuse_policy: ReusePolicy = ReusePolicy()

    @property
    def token_res(self) -> int:
        """Side of the square token grid: latent_size / patch."""
        if self.latent_size % self.patch:
            raise ValueError(f"latent_size {self.latent_size} is not a "
                             f"multiple of patch {self.patch}")
        return self.latent_size // self.patch

    def patch_size(self, resolution: int) -> int:
        """PSXU patch width at a feature-map resolution (the UNet's rule:
        the PSSA bitmap geometry belongs to the kernel)."""
        return min(64, max(16, resolution))

    def smoke(self) -> "DiTConfig":
        """Reduced config that runs a full forward pass on a CPU in
        seconds."""
        return dataclasses.replace(
            self, latent_size=16, hidden_size=64, depth=4, num_heads=4,
            context_dim=32, text_len=8, time_dim=64, groups=8)

    # --- denoiser-contract hooks (repro_torch.diffusion.denoiser) ---
    def layer_order(self) -> tuple:
        """``block{i}`` at the token resolution, for i < depth."""
        return tuple(LayerKey(f"block{i}", self.token_res)
                     for i in range(self.depth))

    def channels_at(self, resolution: int) -> int:
        """Token width at a feature-map resolution (one resolution)."""
        if resolution != self.token_res:
            raise ValueError(f"DiT has one token resolution "
                             f"{self.token_res}, not {resolution}")
        return self.hidden_size

    def full_geometry(self) -> "DiTConfig":
        """Full DiT-S: the analytic ledger's target."""
        return DiTConfig()

    def attn_resolutions(self) -> tuple:
        return (self.token_res,)


DIT_S2 = DiTConfig()


# ----------------------------------------------------------------------------
# Parameter init (same shapes and distributions as the JAX package)
# ----------------------------------------------------------------------------
def init_dit_params(cfg: DiTConfig, generator=None, device=None):
    """Random parameters on ``device`` (``None``: the card)."""
    ini = _Init(generator, resolve_device(device))
    d = cfg.hidden_size
    pe = cfg.patch * cfg.patch * cfg.in_channels
    po = cfg.patch * cfg.patch * cfg.out_channels
    return {
        "patch_embed": ini.lin(pe, d),
        "time_mlp1": ini.lin(d, cfg.time_dim),
        "time_mlp2": ini.lin(cfg.time_dim, cfg.time_dim),
        # 9 modulation vectors a block: (shift, scale, gate) x (sa, ca, ffn)
        "blocks": [{"attn": _transformer_p(ini, d, cfg),
                    "ada": ini.lin(cfg.time_dim, 9 * d)}
                   for _ in range(cfg.depth)],
        "final_norm": ini.norm(d),
        "final_ada": ini.lin(cfg.time_dim, 2 * d),
        "final_out": ini.lin(d, po),
    }


def abstract_dit_params(cfg: DiTConfig):
    """The parameter tree's shapes and dtypes, on the meta device (no
    storage allocated)."""
    return init_dit_params(cfg, None, "meta")


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------
def _patchify(latents, patch: int):
    """(B, S, S, C) -> (B, S/p, S/p, p*p*C) token grid."""
    b, s, _, c = latents.shape
    g = s // patch
    x = latents.reshape(b, g, patch, g, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g, g, patch * patch * c)


def _unpatchify(tokens, patch: int, out_channels: int):
    """(B, T, p*p*C) tokens (square T) -> (B, S, S, C)."""
    b, t, _ = tokens.shape
    g = int(round(t ** 0.5))
    x = tokens.reshape(b, g, g, patch, patch, out_channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * patch, g * patch,
                                               out_channels)


def dit_forward(params, latents, timesteps, context, cfg: DiTConfig,
                tips_active=True, stats_rows=None, cfg_dup: bool = False,
                reuse_cache=None, row_stats: bool = False, overrides=None):
    """latents (B, S, S, C), timesteps (B,), context (B or 2B, Ttext, ctx).

    The signature and keywords of ``unet.unet_forward`` (the denoiser
    contract).  Returns ``(eps, stats)``, plus the new cache under
    temporal reuse, with one PSSA/TIPS entry per block in
    ``cfg.layer_order()``.  ``cfg_dup`` tiles the hidden state after
    block 0's self-attention: under fused CFG block 0 is where the cond
    and uncond halves first differ, as the UNet's first block is.
    """
    g = cfg.token_res
    reuse_on = cfg.reuse_policy.enabled and reuse_cache is not None
    needs_dup = cfg_dup
    if cfg_dup and context.shape[0] != 2 * latents.shape[0]:
        raise ValueError(f"cfg_dup needs 2x context rows: context "
                         f"{tuple(context.shape)}, latents "
                         f"{tuple(latents.shape)}")

    temb = timestep_embedding(timesteps, cfg.hidden_size)
    temb = temb @ params["time_mlp1"]["w"] + params["time_mlp1"]["b"]
    temb = F.silu(temb) @ params["time_mlp2"]["w"] + params["time_mlp2"]["b"]

    h = (_patchify(latents, cfg.patch) @ params["patch_embed"]["w"]
         + params["patch_embed"]["b"])

    pssa_stats, tips_stats, reuse_stats, new_layer_caches = [], [], [], []
    for i, bp in enumerate(params["blocks"]):
        # per-block adaLN from the (not yet tiled) time embedding; the
        # block tiles the (B, 1, D) vectors to [cond | uncond] itself
        ada = F.silu(temb) @ bp["ada"]["w"] + bp["ada"]["b"]
        mod = tuple(m[:, None, :] for m in torch.chunk(ada, 9, dim=-1))
        reuse = None
        if reuse_on:
            reuse = (cfg.reuse_policy, reuse_cache.layers[i],
                     reuse_cache.valid)
        h, sa, ca, ru = _transformer_block(h, bp["attn"], context, cfg,
                                           tips_active, stats_rows,
                                           dup_after_self=needs_dup,
                                           reuse=reuse, row_stats=row_stats,
                                           overrides=overrides,
                                           modulation=mod)
        if needs_dup:
            temb = torch.cat([temb, temb], dim=0)
            needs_dup = False
        pssa_stats.append(sa)
        tips_stats.append(ca)
        if reuse_on:
            new_layer_caches.append(ru[0])
            reuse_stats.append(ru[1])

    if needs_dup:                      # depth 0: tile eps as the UNet does
        h = torch.cat([h, h], dim=0)
        temb = torch.cat([temb, temb], dim=0)

    tokens = h.reshape(h.shape[0], g * g, cfg.hidden_size)
    ada = F.silu(temb) @ params["final_ada"]["w"] + params["final_ada"]["b"]
    shift, scale = torch.chunk(ada, 2, dim=-1)
    hn = layer_norm(tokens, params["final_norm"]["scale"],
                    params["final_norm"]["bias"])
    hn = hn * (1.0 + scale[:, None, :]) + shift[:, None, :]
    out = hn @ params["final_out"]["w"] + params["final_out"]["b"]
    eps = _unpatchify(out, cfg.patch, cfg.out_channels)

    stats_cls = SlotStats if row_stats else UNetStats
    stats = stats_cls.from_layer_list(attn_layer_order(cfg), pssa_stats,
                                      tips_stats, reuse=reuse_stats)
    if reuse_on:
        new_cache = ReuseCache(valid=torch.ones_like(reuse_cache.valid),
                               layers=tuple(new_layer_caches))
        return eps, stats, new_cache
    return eps, stats


# --- denoiser-contract registration (repro_torch.diffusion.denoiser) ---
from repro_torch.diffusion import denoiser as _denoiser  # noqa: E402

_denoiser.register_family(_denoiser.FamilySpec(
    family="dit", config_cls=DiTConfig, init_params=init_dit_params,
    forward=dit_forward, abstract_params=abstract_dit_params))
