"""Shared LM layers the Mamba-2 path needs: RMS norm, embedding and the
float32 unembedding (port of part of ``repro.models.layers``).

The port has no mesh yet, so there is no ``ShardCtx`` and no ``ctx``
argument.
"""
from __future__ import annotations

import torch


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
