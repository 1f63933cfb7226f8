"""Plain reference of the BK-SDM UNet: SD-v1 blocks with one resnet and
one transformer block per down stage, two per up stage, no mid block.

``forward`` takes the whole classifier-free-guidance batch ``[cond |
uncond]`` and returns (eps, per-block counters in forward order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (conv2d, group_norm, timestep_embedding,
                     transformer_block, upsample2x)
from .params import conv, lin, norm, transformer


def _resnet(x, p, temb, groups):
    h = group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    h = h + (F.silu(temb) @ p["time"]["w"] + p["time"]["b"])[:, None, None, :]
    h = group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    skip = x if "skip" not in p else conv2d(x, p["skip"]["w"],
                                            p["skip"]["b"], padding=0)
    return skip + h


def forward(p, latents, timesteps, context, cfg: dict, feat: dict,
            tips_active, n_cond: int, dense: bool = False):
    heads, groups = cfg["num_heads"], cfg["groups"]
    counters = []

    def attn(h, bp):
        h, c = transformer_block(h, bp, context, heads, groups, feat,
                                 tips_active, n_cond, dense=dense)
        counters.append(c)
        return h

    temb = timestep_embedding(timesteps, cfg["block_channels"][0])
    temb = temb @ p["time_mlp1"]["w"] + p["time_mlp1"]["b"]
    temb = F.silu(temb) @ p["time_mlp2"]["w"] + p["time_mlp2"]["b"]
    h = conv2d(latents, p["conv_in"]["w"], p["conv_in"]["b"])
    skips = [h]
    for stage in p["down"]:
        for r, rp in enumerate(stage["resnets"]):
            h = _resnet(h, rp, temb, groups)
            if stage["attns"]:
                h = attn(h, stage["attns"][r])
            skips.append(h)
        if "down" in stage:
            h = conv2d(h, stage["down"]["w"], stage["down"]["b"], stride=2)
            skips.append(h)
    for stage in p["up"]:
        for r, rp in enumerate(stage["resnets"]):
            h = _resnet(torch.cat([h, skips.pop()], dim=-1), rp, temb, groups)
            if stage["attns"]:
                h = attn(h, stage["attns"][r])
        if "up" in stage:
            h = conv2d(upsample2x(h), stage["up"]["w"], stage["up"]["b"])
    h = group_norm(h, p["norm_out"]["scale"], p["norm_out"]["bias"], groups)
    eps = conv2d(F.silu(h), p["conv_out"]["w"], p["conv_out"]["b"])
    return eps, counters


def _resnet_p(cin, cout, tdim):
    p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
         "time": lin(tdim, cout), "norm2": norm(cout),
         "conv2": conv(3, cout, cout)}
    if cin != cout:
        p["skip"] = conv(1, cin, cout)
    return p


def param_shapes(cfg: dict) -> dict:
    chans = cfg["block_channels"]
    tdim = cfg["time_dim"]

    def block(c):
        return transformer(c, cfg["context_dim"], cfg["ffn_mult"])
    p = {"time_mlp1": lin(chans[0], tdim), "time_mlp2": lin(tdim, tdim),
         "conv_in": conv(3, cfg["in_channels"], chans[0])}
    down, skip_c, cin = [], [chans[0]], chans[0]
    for i, cout in enumerate(chans):
        stage = {"resnets": [], "attns": []}
        for _ in range(cfg["resnets_per_down"]):
            stage["resnets"].append(_resnet_p(cin, cout, tdim))
            if cfg["down_attn"][i]:
                stage["attns"].append(block(cout))
            cin = cout
            skip_c.append(cout)
        if i < len(chans) - 1:
            stage["down"] = conv(3, cout, cout)
            skip_c.append(cout)
        down.append(stage)
    up = []
    for j, i in enumerate(reversed(range(len(chans)))):
        cout = chans[i]
        stage = {"resnets": [], "attns": []}
        for _ in range(cfg["resnets_per_up"]):
            stage["resnets"].append(_resnet_p(cin + skip_c.pop(), cout, tdim))
            if cfg["down_attn"][i]:
                stage["attns"].append(block(cout))
            cin = cout
        if j < len(chans) - 1:
            stage["up"] = conv(3, cout, cout)
        up.append(stage)
    p.update(down=down, up=up, norm_out=norm(chans[0]),
             conv_out=conv(3, chans[0], cfg["out_channels"]))
    return p


def attention_layers(cfg: dict) -> list:
    """(resolution, channels) of each transformer block, forward order."""
    out, s = [], cfg["latent_size"]
    chans = cfg["block_channels"]
    for i, a in enumerate(cfg["down_attn"]):
        if a:
            out += [(s >> i, chans[i])] * cfg["resnets_per_down"]
    for i in reversed(range(len(chans))):
        if cfg["down_attn"][i]:
            out += [(s >> i, chans[i])] * cfg["resnets_per_up"]
    return out
