"""VAE decoder (port of ``repro.diffusion.vae``): latents -> RGB image.

SD-v1 decoder geometry: 4-channel S x S latents decode to an (8S, 8S, 3)
image through three nearest-neighbour x2 stages with resnet blocks.  NHWC
at the public function; conv weights OIHW.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.diffusion.unet import (_Init, conv2d, group_norm,
                                        upsample_nearest2x)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    channels: tuple = (512, 512, 256, 128)
    resnets_per_stage: int = 2
    groups: int = 32
    scale_factor: float = 0.18215       # SD-v1 latent scaling

    def smoke(self) -> "VAEConfig":
        return dataclasses.replace(self, channels=(32, 32, 16, 16), groups=8)


SD_VAE = VAEConfig()


def _resnet_p(ini: _Init, cin, cout):
    p = {"norm1": ini.norm(cin), "conv1": ini.conv(3, 3, cin, cout),
         "norm2": ini.norm(cout), "conv2": ini.conv(3, 3, cout, cout)}
    if cin != cout:
        p["skip"] = ini.conv(1, 1, cin, cout)
    return p


def init_vae_params(cfg: VAEConfig, generator=None, device="cpu"):
    ini = _Init(generator, device)
    chans = cfg.channels
    p = {"conv_in": ini.conv(3, 3, cfg.latent_channels, chans[0])}
    stages, cin = [], chans[0]
    for i, cout in enumerate(chans):
        st = {"resnets": []}
        for _ in range(cfg.resnets_per_stage):
            st["resnets"].append(_resnet_p(ini, cin, cout))
            cin = cout
        if i < len(chans) - 1:
            st["up"] = ini.conv(3, 3, cout, cout)
        stages.append(st)
    p["stages"] = stages
    p["norm_out"] = ini.norm(chans[-1])
    p["conv_out"] = ini.conv(3, 3, chans[-1], cfg.out_channels)
    return p


def _resnet(x, p, groups):
    h = group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    h = group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    skip = x if "skip" not in p else conv2d(x, p["skip"]["w"],
                                            p["skip"]["b"], padding=0)
    return skip + h


def decode(params, latents: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """(B, S, S, 4) latents -> (B, 8S, 8S, 3) image in [-1, 1]."""
    h = conv2d(latents / cfg.scale_factor, params["conv_in"]["w"],
               params["conv_in"]["b"])
    for st in params["stages"]:
        for rp in st["resnets"]:
            h = _resnet(h, rp, cfg.groups)
        if "up" in st:
            h = conv2d(upsample_nearest2x(h), st["up"]["w"], st["up"]["b"])
    h = group_norm(h, params["norm_out"]["scale"],
                   params["norm_out"]["bias"], cfg.groups)
    return torch.tanh(conv2d(F.silu(h), params["conv_out"]["w"],
                             params["conv_out"]["b"]))
