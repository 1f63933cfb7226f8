"""Plain reference of the SD-v1 VAE decoder: 4-channel latents to an
(8S, 8S, 3) image in [-1, 1] through three nearest-neighbour x2 stages."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import conv2d, group_norm, upsample2x
from .params import conv, norm


def _resnet(x, p, groups):
    h = group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    h = group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    skip = x if "skip" not in p else conv2d(x, p["skip"]["w"],
                                            p["skip"]["b"], padding=0)
    return skip + h


def decode(p, latents: torch.Tensor, cfg: dict) -> torch.Tensor:
    h = conv2d(latents / cfg["scale_factor"], p["conv_in"]["w"],
               p["conv_in"]["b"])
    for st in p["stages"]:
        for rp in st["resnets"]:
            h = _resnet(h, rp, cfg["groups"])
        if "up" in st:
            h = conv2d(upsample2x(h), st["up"]["w"], st["up"]["b"])
    h = group_norm(h, p["norm_out"]["scale"], p["norm_out"]["bias"],
                   cfg["groups"])
    return torch.tanh(conv2d(F.silu(h), p["conv_out"]["w"],
                             p["conv_out"]["b"]))


def _resnet_p(cin, cout):
    p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
         "norm2": norm(cout), "conv2": conv(3, cout, cout)}
    if cin != cout:
        p["skip"] = conv(1, cin, cout)
    return p


def param_shapes(cfg: dict) -> dict:
    chans = cfg["channels"]
    p = {"conv_in": conv(3, cfg["latent_channels"], chans[0])}
    stages, cin = [], chans[0]
    for i, cout in enumerate(chans):
        st = {"resnets": []}
        for _ in range(cfg["resnets_per_stage"]):
            st["resnets"].append(_resnet_p(cin, cout))
            cin = cout
        if i < len(chans) - 1:
            st["up"] = conv(3, cout, cout)
        stages.append(st)
    p["stages"] = stages
    p["norm_out"] = norm(chans[-1])
    p["conv_out"] = conv(3, chans[-1], cfg["out_channels"])
    return p
