"""CLIP-style text encoder (port of ``repro.diffusion.text_encoder``).

Bidirectional pre-LN transformer over the caption tokens with the CLS
token first, the position TIPS relies on.  Full size mirrors CLIP
ViT-L/14's text tower (12 layers, d=768, 77 tokens).  Parameters are a
nested dict of tensors in the JAX layout: linear weights are (in, out) and
applied as ``x @ w``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    max_len: int = 77
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072

    def smoke(self) -> "TextEncoderConfig":
        return dataclasses.replace(self, vocab_size=256, max_len=8,
                                   d_model=32, num_layers=2, num_heads=4,
                                   d_ff=64)


def init_text_encoder_params(cfg: TextEncoderConfig, generator=None,
                             device="cpu"):
    """Random parameters with the JAX package's shapes and distributions
    (normal weights scaled by fan-in, unit norms, zero norm biases)."""
    d, dff = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def layer():
        return {
            "ln1": torch.ones(d, device=device),
            "ln1_b": torch.zeros(d, device=device),
            "wqkv": normal((d, 3 * d), d ** -0.5),
            "wo": normal((d, d), d ** -0.5),
            "ln2": torch.ones(d, device=device),
            "ln2_b": torch.zeros(d, device=device),
            "w1": normal((d, dff), d ** -0.5),
            "w2": normal((dff, d), dff ** -0.5),
        }

    return {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "pos": normal((cfg.max_len, d), 0.01),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "ln_f": torch.ones(d, device=device),
        "ln_f_b": torch.zeros(d, device=device),
    }


def _ln(x, scale, bias, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def encode_text(params, tokens: torch.Tensor, cfg: TextEncoderConfig):
    """tokens (B, T) int, CLS at position 0 -> (B, T, d) context."""
    b, t = tokens.shape
    h = params["embed"][tokens.long()] + params["pos"][None, :t]
    nh, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    for lp in params["layers"]:
        x = _ln(h, lp["ln1"], lp["ln1_b"])
        qkv = x @ lp["wqkv"]
        q, k, v = (z.reshape(b, t, nh, hd) for z in qkv.chunk(3, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, -1)
        h = h + o @ lp["wo"]
        x = _ln(h, lp["ln2"], lp["ln2_b"])
        h = h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
    return _ln(h, params["ln_f"], params["ln_f_b"])
