"""Parameter-tree leaves of the reference: (shape, init) pairs.

Uniform weights span +-1/sqrt(fan_in), biases are zero, norms scale 1 and
shift 0: the distributions the port's own random initialisers draw from.
"""
from __future__ import annotations

import math


def conv(k: int, cin: int, cout: int) -> dict:
    return {"w": ((cout, cin, k, k), ("uniform", 1.0 / math.sqrt(k * k * cin))),
            "b": ((cout,), ("zeros",))}


def lin(cin: int, cout: int, bias: bool = True) -> dict:
    p = {"w": ((cin, cout), ("uniform", 1.0 / math.sqrt(cin)))}
    if bias:
        p["b"] = ((cout,), ("zeros",))
    return p


def norm(c: int) -> dict:
    return {"scale": ((c,), ("ones",)), "bias": ((c,), ("zeros",))}


def transformer(c: int, context_dim: int, ffn_mult: int) -> dict:
    dff = ffn_mult * c
    return {"norm_in": norm(c), "proj_in": lin(c, c), "ln1": norm(c),
            "sa_q": lin(c, c, False), "sa_k": lin(c, c, False),
            "sa_v": lin(c, c, False), "sa_o": lin(c, c), "ln2": norm(c),
            "ca_q": lin(c, c, False), "ca_k": lin(context_dim, c, False),
            "ca_v": lin(context_dim, c, False), "ca_o": lin(c, c),
            "ln3": norm(c), "ff_geglu": lin(c, 2 * dff),
            "ff_out": lin(dff, c), "proj_out": lin(c, c)}
