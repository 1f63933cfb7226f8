"""Plain reference of the text-conditioned DiT: patchify, N transformer
blocks under adaLN (shift, scale, gate per stage from the timestep), a
modulated final norm, projection to patch pixels, unpatchify."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import layer_norm, timestep_embedding, transformer_block
from .params import lin, norm, transformer


def forward(p, latents, timesteps, context, cfg: dict, feat: dict,
            tips_active, n_cond: int, dense: bool = False):
    b, s, _, c = latents.shape
    pt, d = cfg["patch"], cfg["hidden_size"]
    g = s // pt
    temb = timestep_embedding(timesteps, d)
    temb = temb @ p["time_mlp1"]["w"] + p["time_mlp1"]["b"]
    temb = F.silu(temb) @ p["time_mlp2"]["w"] + p["time_mlp2"]["b"]
    x = latents.reshape(b, g, pt, g, pt, c).permute(0, 1, 3, 2, 4, 5)
    h = x.reshape(b, g, g, pt * pt * c) @ p["patch_embed"]["w"] \
        + p["patch_embed"]["b"]
    counters = []
    for bp in p["blocks"]:
        ada = F.silu(temb) @ bp["ada"]["w"] + bp["ada"]["b"]
        mod = tuple(m[:, None, :] for m in torch.chunk(ada, 9, dim=-1))
        h, cnt = transformer_block(h, bp["attn"], context, cfg["num_heads"],
                                   cfg["groups"], feat, tips_active, n_cond,
                                   modulation=mod, dense=dense)
        counters.append(cnt)
    tokens = h.reshape(b, g * g, d)
    shift, scale = torch.chunk(
        F.silu(temb) @ p["final_ada"]["w"] + p["final_ada"]["b"], 2, dim=-1)
    hn = layer_norm(tokens, p["final_norm"]["scale"], p["final_norm"]["bias"])
    hn = hn * (1.0 + scale[:, None, :]) + shift[:, None, :]
    out = hn @ p["final_out"]["w"] + p["final_out"]["b"]
    co = cfg["out_channels"]
    eps = out.reshape(b, g, g, pt, pt, co).permute(0, 1, 3, 2, 4, 5)
    return eps.reshape(b, s, s, co), counters


def param_shapes(cfg: dict) -> dict:
    d, tdim = cfg["hidden_size"], cfg["time_dim"]
    pe = cfg["patch"] ** 2 * cfg["in_channels"]
    po = cfg["patch"] ** 2 * cfg["out_channels"]
    return {"patch_embed": lin(pe, d), "time_mlp1": lin(d, tdim),
            "time_mlp2": lin(tdim, tdim),
            "blocks": [{"attn": transformer(d, cfg["context_dim"],
                                            cfg["ffn_mult"]),
                        "ada": lin(tdim, 9 * d)}
                       for _ in range(cfg["depth"])],
            "final_norm": norm(d), "final_ada": lin(tdim, 2 * d),
            "final_out": lin(d, po)}


def attention_layers(cfg: dict) -> list:
    """(resolution, channels) of each transformer block, forward order."""
    g = cfg["latent_size"] // cfg["patch"]
    return [(g, cfg["hidden_size"])] * cfg["depth"]
