"""Plain reference of the CLIP-style text tower: a bidirectional pre-LN
transformer over the caption tokens, CLS first."""
from __future__ import annotations

import math

import torch

from .layers import gelu, layer_norm


def encode(p, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """tokens (B, T) -> (B, T, d) context."""
    b, t = tokens.shape
    h = p["embed"][tokens.long()] + p["pos"][None, :t]
    nh = cfg["num_heads"]
    hd = cfg["d_model"] // nh
    for lp in p["layers"]:
        x = layer_norm(h, lp["ln1"], lp["ln1_b"])
        q, k, v = (z.reshape(b, t, nh, hd).transpose(1, 2)
                   for z in (x @ lp["wqkv"]).chunk(3, dim=-1))
        probs = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd),
                              dim=-1)
        h = h + (probs @ v).transpose(1, 2).reshape(b, t, -1) @ lp["wo"]
        x = layer_norm(h, lp["ln2"], lp["ln2_b"])
        h = h + gelu(x @ lp["w1"]) @ lp["w2"]
    return layer_norm(h, p["ln_f"], p["ln_f_b"])


def param_shapes(cfg: dict) -> dict:
    """The parameter tree: leaf -> (shape, init), init one of
    ``("normal", std)``, ``("ones",)``, ``("zeros",)``."""
    d, dff = cfg["d_model"], cfg["d_ff"]

    def layer():
        return {"ln1": ((d,), ("ones",)), "ln1_b": ((d,), ("zeros",)),
                "wqkv": ((d, 3 * d), ("normal", d ** -0.5)),
                "wo": ((d, d), ("normal", d ** -0.5)),
                "ln2": ((d,), ("ones",)), "ln2_b": ((d,), ("zeros",)),
                "w1": ((d, dff), ("normal", d ** -0.5)),
                "w2": ((dff, d), ("normal", dff ** -0.5))}
    return {"embed": ((cfg["vocab_size"], d), ("normal", 0.02)),
            "pos": ((cfg["max_len"], d), ("normal", 0.01)),
            "layers": [layer() for _ in range(cfg["num_layers"])],
            "ln_f": ((d,), ("ones",)), "ln_f_b": ((d,), ("zeros",))}
