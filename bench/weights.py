"""Random weights made on the device from the seed, in the parameter layout
the program takes (``DiffusionEngine(params=)``): ``{"text", "unet",
"vae"}`` nested dicts, conv weights OIHW, linear weights (in, out).

One ``torch.Generator`` on the device fills one uniform and one normal
buffer in two calls; each leaf is a view of its slice, scaled in place.
Zeros and ones are carved from two more buffers.  The program and the
reference are handed the same tensors.
"""
from __future__ import annotations

import math

import torch

from reference import sampling, text, vae


def shapes(model: dict) -> dict:
    """The (shape, init) tree of a configuration."""
    return {"text": text.param_shapes(model["text"]),
            "unet": sampling.family(model["family"]).param_shapes(
                model["unet"]),
            "vae": vae.param_shapes(model["vae"])}


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _leaves(tree, out):
    if _is_leaf(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def _build(tree, take):
    if _is_leaf(tree):
        return take(tree)
    if isinstance(tree, dict):
        return {k: _build(v, take) for k, v in tree.items()}
    return [_build(v, take) for v in tree]


def make(model: dict, seed: int, device) -> dict:
    tree = shapes(model)
    kinds = ("uniform", "normal", "zeros", "ones")
    total = dict.fromkeys(kinds, 0)
    for shape, init in _leaves(tree, []):
        total[init[0]] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = {
        "uniform": torch.rand(total["uniform"], generator=gen,
                              device=device).mul_(2.0).sub_(1.0),
        "normal": torch.randn(total["normal"], generator=gen, device=device),
        "zeros": torch.zeros(total["zeros"], device=device),
        "ones": torch.ones(total["ones"], device=device),
    }
    at = dict.fromkeys(kinds, 0)

    def take(leaf):
        shape, init = leaf
        n = math.prod(shape)
        kind = init[0]
        t = buf[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind in ("uniform", "normal"):
            t.mul_(init[1])
        return t
    return _build(tree, take)


def meta(model: dict) -> dict:
    """The same tree on the meta device (FLOP counting; no storage)."""
    return _build(shapes(model),
                  lambda leaf: torch.empty(leaf[0], device="meta"))
