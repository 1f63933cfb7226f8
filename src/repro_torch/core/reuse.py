"""ReusePolicy — temporal patch reuse across denoising steps (port of
``repro.core.reuse``).

Between consecutive denoising steps, and between an edited request and
its recorded base, few activation patches change.  Each transformer block
compares its token input with a cached reference patch by patch
(``kernels/patch_reuse``), gathers the rows of the active patches, runs
self-attention queries, cross-attention and the FFN on those rows alone,
and scatters the results over the cached stage outputs
(``diffusion.unet._transformer_block``).

Exactness (DESIGN.md §9): at ``threshold=0`` every patch is active, the
gather plan is the identity, and the block is bit-identical to the dense
path, outputs and reuse counters alike.

Modes:

``temporal``  the cache is the previous step's activations, carried by
              the sampler loop.  ``capacity`` stays 1.0: a fresh cache is
              invalid, so every patch is active on a row's first step.
``edit``      the cache is a base request's recorded per-step activations
              (img2img).  They are valid from step 0, so ``capacity < 1``
              really shrinks the gathered shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

_MODES = ("off", "temporal", "edit")


@dataclasses.dataclass(frozen=True)
class ReusePolicy:
    """Temporal patch-reuse decisions (frozen and hashable).

    ``threshold``: a patch is active iff the max-abs delta of its tokens
    against the cached reference reaches it (0.0: every patch active).
    ``capacity``: fraction of patch slots the gather keeps per row.
    Invalid cache rows force all their patches active.

    ``apriori_window``: a ``(y0, x0, h, w)`` rectangle in latent pixels.
    When the changed region is known up front, patch activity is a
    constant (``window_patch_mask``) and the patch-delta op is skipped.
    """
    enabled: bool = False
    threshold: float = 0.0
    capacity: float = 1.0
    apriori_window: Tuple[int, int, int, int] | None = None

    def __post_init__(self):
        if self.threshold < 0.0:
            raise ValueError(
                f"ReusePolicy.threshold={self.threshold}: patch deltas are "
                f"max-abs values — expected >= 0")
        if not 0.0 < self.capacity <= 1.0:
            raise ValueError(
                f"ReusePolicy.capacity={self.capacity}: expected a patch "
                f"fraction in (0, 1]")
        if self.apriori_window is not None:
            win = tuple(int(v) for v in self.apriori_window)
            if len(win) != 4 or win[2] < 1 or win[3] < 1 or win[0] < 0 \
                    or win[1] < 0:
                raise ValueError(
                    f"ReusePolicy.apriori_window={self.apriori_window}: "
                    f"expected (y0, x0, h, w) with y0,x0 >= 0 and h,w >= 1")
            object.__setattr__(self, "apriori_window", win)

    # -- presets ---------------------------------------------------------
    @classmethod
    def off(cls) -> "ReusePolicy":
        """Dense path: no cache threaded, no reuse counters."""
        return cls()

    @classmethod
    def temporal(cls, threshold: float = 0.05) -> "ReusePolicy":
        """Previous-step reuse carried through the sampler loop."""
        return cls(enabled=True, threshold=threshold, capacity=1.0)

    @classmethod
    def edit(cls, threshold: float = 0.05,
             capacity: float = 0.125) -> "ReusePolicy":
        """Base-request reuse with a shrunken gather (img2img)."""
        return cls(enabled=True, threshold=threshold, capacity=capacity)

    @classmethod
    def parse(cls, spec: str) -> "ReusePolicy":
        """Build a policy from a CLI spec: a mode name (``off`` |
        ``temporal`` | ``edit``) and/or ``key=value`` overrides, e.g.
        ``"temporal,threshold=0.02"`` or ``"edit,window=4:4:8:8"``."""
        pol = None
        fields = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            if item in _MODES:
                pol = cls.off() if item == "off" else getattr(cls, item)()
                continue
            if "=" not in item:
                raise ValueError(
                    f"reuse policy spec {item!r}: expected a mode in "
                    f"{_MODES} or key=value")
            key, val = (s.strip() for s in item.split("=", 1))
            if key in ("threshold", "capacity"):
                fields[key] = float(val)
            elif key == "enabled":
                if val.lower() not in ("true", "false"):
                    raise ValueError(
                        f"reuse policy spec: enabled={val!r} (expected true "
                        f"or false)")
                fields["enabled"] = val.lower() == "true"
            elif key == "window":
                parts = val.split(":")
                if len(parts) != 4:
                    raise ValueError(
                        f"reuse policy spec: window={val!r} (expected "
                        f"y0:x0:h:w in latent pixels)")
                fields["apriori_window"] = tuple(int(p) for p in parts)
            else:
                raise ValueError(
                    f"reuse policy spec: unknown key {key!r} (expected "
                    f"threshold, capacity, window or enabled)")
        base = pol if pol is not None else cls()
        return dataclasses.replace(base, **fields) if fields else base

    # -- views -----------------------------------------------------------
    def cap_patches(self, num_patches: int) -> int:
        """Gather width: how many patch slots the plan keeps."""
        return min(num_patches,
                   max(1, int(math.ceil(self.capacity * num_patches))))

    def describe(self) -> dict:
        """JSON-friendly view."""
        return {"enabled": self.enabled, "threshold": self.threshold,
                "capacity": self.capacity,
                "apriori_window": (None if self.apriori_window is None
                                   else list(self.apriori_window))}


class ReuseRowCounters(NamedTuple):
    """Per-row integer reuse counters of ONE transformer block.

    ``computed``: patches gathered and recomputed this step; ``total``:
    patches in the block's token grid.  Reuse ratio = 1 - computed/total.
    """
    computed: torch.Tensor   # (rows,) int32
    total: torch.Tensor      # (rows,) int32


class LayerReuseCache(NamedTuple):
    """Cached activations of one transformer block (one denoising step).

    ``ref`` is the block's token input (the delta reference); ``sa`` /
    ``ca`` / ``ffn`` are the three pre-residual stage outputs.  Under
    fused CFG the first block's ``ref``/``sa`` hold the cond rows only (B)
    and ``ca``/``ffn`` hold [cond | uncond] (2B).
    """
    ref: torch.Tensor    # (rows_pre, T, C)
    sa: torch.Tensor     # (rows_pre, T, C)
    ca: torch.Tensor     # (rows_post, T, C)
    ffn: torch.Tensor    # (rows_post, T, C)


@dataclasses.dataclass(frozen=True)
class ReuseCache:
    """Cached activations of every transformer block, per request row.

    ``valid`` holds one bool per request row (the cond half under CFG):
    False forces every patch of that row active on the next step.
    ``layers`` follows ``stats.attn_layer_order``.
    """
    valid: torch.Tensor                     # (B,) bool
    layers: Tuple[LayerReuseCache, ...]

    def invalidate_row(self, row) -> "ReuseCache":
        """Mark one request row stale (a copy; this cache is unchanged)."""
        valid = self.valid.clone()
        valid[row] = False
        return dataclasses.replace(self, valid=valid)


def window_patch_mask(window, resolution: int, patch: int,
                      latent_size: int) -> tuple:
    """Per-patch activity for an a-priori edit window.

    ``window`` is ``(y0, x0, h, w)`` in latent pixels.  A patch of
    ``patch`` contiguous row-major tokens at ``resolution`` is active iff
    one of its tokens falls inside the window scaled to that resolution,
    outer bounds rounded outward.  A tuple of Python bools.
    """
    y0, x0, h, w = (int(v) for v in window)
    tokens = resolution * resolution
    npatch = max(1, tokens // patch)
    y0r = (y0 * resolution) // latent_size
    x0r = (x0 * resolution) // latent_size
    y1r = -((-(y0 + h) * resolution) // latent_size)   # ceil division
    x1r = -((-(x0 + w) * resolution) // latent_size)
    y1r = min(resolution, max(y1r, y0r + 1))
    x1r = min(resolution, max(x1r, x0r + 1))
    mask = []
    for p in range(npatch):
        active = False
        for tok in range(p * patch, min((p + 1) * patch, tokens)):
            y, x = tok // resolution, tok % resolution
            if y0r <= y < y1r and x0r <= x < x1r:
                active = True
                break
        mask.append(active)
    return tuple(mask)


def layer_channels(cfg, resolution: int) -> int:
    """Channel width of the transformer block at ``resolution``: the
    config's ``channels_at`` hook (every registered denoiser family),
    else the UNet rule (``latent_size >> i`` is stage i's resolution, on
    the way down and again on the way up, with ``block_channels[i]``)."""
    ch_fn = getattr(cfg, "channels_at", None)
    if callable(ch_fn):
        return ch_fn(resolution)
    stage = (cfg.latent_size // resolution).bit_length() - 1
    return cfg.block_channels[stage]


def reuse_cache_zeros(cfg, batch: int, use_cfg: bool,
                      device="cpu") -> ReuseCache:
    """All-invalid cache matching the denoiser's block geometry (the
    UNet's, or DiT's: one width at one token resolution).

    ``use_cfg`` mirrors the fused-CFG prefix dedup: the first attention
    block runs its self-attention on B rows, every later stage on 2B.
    The zero payloads are never read: every patch of an invalid row is
    active.
    """
    from repro_torch.diffusion.stats import attn_layer_order

    mult = 2 if use_cfg else 1
    layers = []
    for idx, lk in enumerate(attn_layer_order(cfg)):
        t = lk.resolution * lk.resolution
        c = cfg.channels_at(lk.resolution)
        pre = batch if (use_cfg and idx == 0) else batch * mult
        post = batch * mult

        def zeros(rows):
            return torch.zeros((rows, t, c), dtype=torch.float32,
                               device=device)
        layers.append(LayerReuseCache(ref=zeros(pre), sa=zeros(pre),
                                      ca=zeros(post), ffn=zeros(post)))
    return ReuseCache(valid=torch.zeros((batch,), dtype=torch.bool,
                                        device=device),
                      layers=tuple(layers))
