"""Gradient compression for the data-parallel all-reduce (port of
``repro.optim.compression``).

INT8 with error feedback: each step quantizes (grad + residual) to int8
on one scale per leaf, carries the int8 payload and its scale (what the
wire would carry, a quarter of the float32 bytes), and keeps the
quantization error for the next step.  As in the JAX package, the
trainer compresses after the data-parallel reduction, so
``error_feedback_update`` is the round trip it applies; a leaf split over
the model axis takes its scale from the whole leaf's amax (a MAX over the
axis), as the unsplit leaf would.

Scales are ``max(amax, 1e-12) * float32(1 / 127)``: inside ``jit`` XLA
turns the JAX package's division by the constant 127 into that product,
and keeps ``x / scale`` (not a constant) a true division.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.models.parallel import all_reduced

_INV_QMAX = 1.0 / 127.0


def _q(x: torch.Tensor, tp_group=None):
    amax = torch.max(torch.abs(x))
    if tp_group is not None:
        amax = all_reduced(amax, tp_group, "tp_all_reduce", dist.ReduceOp.MAX)
    scale = torch.clamp_min(amax, 1e-12) * _INV_QMAX
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads, residual=None, split=None, tp_group=None):
    """-> (a tree of (int8 payload, float32 scale) pairs, the new float32
    residual tree).  ``split`` / ``tp_group`` as in ``AdamW.update``."""
    if residual is None:
        residual = tree_util.tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    flat = tree_util.leaves(grads)
    split = split or [None] * len(flat)
    pairs = []
    for g, r, s in zip(flat, tree_util.leaves(residual), split):
        x = g.to(torch.float32) + r
        q, scale = _q(x, None if s is None else tp_group)
        pairs.append(((q, scale), x - q.to(torch.float32) * scale))
    qtree = tree_util.unflatten(grads, (p[0] for p in pairs))
    new_res = tree_util.unflatten(grads, (p[1] for p in pairs))
    return qtree, new_res


def decompress_gradients(qtree):
    """The float32 gradients a tree of (int8, scale) pairs carries."""
    if isinstance(qtree, tuple) and len(qtree) == 2 \
            and isinstance(qtree[0], torch.Tensor) \
            and qtree[0].dtype == torch.int8:
        return qtree[0].to(torch.float32) * qtree[1]
    if isinstance(qtree, dict):
        return {k: decompress_gradients(v) for k, v in qtree.items()}
    if isinstance(qtree, (list, tuple)):
        return type(qtree)(decompress_gradients(v) for v in qtree)
    raise TypeError(f"not a compressed gradient tree: {type(qtree)}")


def error_feedback_update(grads, residual, split=None, tp_group=None):
    """Round-trip compress and decompress (what the wire would carry) and
    the new residual."""
    qtree, new_res = compress_gradients(grads, residual, split, tp_group)
    return decompress_gradients(qtree), new_res
