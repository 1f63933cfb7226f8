"""AdamW over parameter trees (port of ``repro.optim.adamw``).

The state mirrors the parameter tree: float32 first and second moments
per leaf, and an int32 step.  ``update`` is functional (it returns new
trees and leaves its arguments as they are), so it can be held against
the JAX package's step for step: global-norm clip, bias correction and
decoupled weight decay in float32, the new parameter cast back to the
parameter's dtype.

On a mesh the moments follow the parameter shards (``init`` of this
rank's shard), as the JAX package's same PartitionSpecs shard them, and
the global norm sums the squares of the split parts over the model axis
and counts each whole (replicated) part once: a whole leaf, and the
replicated tail of a ``Split`` with a ``head`` (a Mamba-2 ``in_xbc``'s B
and C channels, on every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.models.parallel import all_reduced


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        dev = tree_util.leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_util.tree_map(zeros, params),
            v=tree_util.tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamWState, params, split=None,
               tp_group=None):
        """-> (new params, new state, the global gradient norm before the
        clip).  ``split``: for each leaf in flatten order, its
        ``parallel.Split`` over ``tp_group`` (this rank holds a shard), or
        None (whole)."""
        flat_g = tree_util.leaves(grads)

        def sumsq(g):
            return torch.sum(torch.square(g.to(torch.float32)))
        if split is None or not any(split):
            # the global norm, leaf sums added in flatten order
            gnorm = torch.sqrt(sum(sumsq(g) for g in flat_g))
        else:
            tp = dist.get_world_size(tp_group)
            zero = torch.zeros((), dtype=torch.float32,
                               device=flat_g[0].device)
            mine, whole = zero, zero
            for g, s in zip(flat_g, split):
                part, tail = (None, g) if s is None else s.parts(g, tp)
                if part is not None:
                    mine = mine + sumsq(part)
                if tail is not None:
                    whole = whole + sumsq(tail)
            gnorm = torch.sqrt(all_reduced(mine, tp_group, "tp_all_reduce")
                               + whole)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1c = 1.0 - torch.pow(self.b1, step.to(torch.float32))
        b2c = 1.0 - torch.pow(self.b2, step.to(torch.float32))
        lr = self._lr(step)

        def upd(g, m, v, p):
            g = g.to(torch.float32) * scale
            m2 = self.b1 * m + (1 - self.b1) * g
            v2 = self.b2 * v + (1 - self.b2) * torch.square(g)
            mh = m2 / b1c
            vh = v2 / b2c
            delta = mh / (torch.sqrt(vh) + self.eps)
            delta = delta + self.weight_decay * p.to(torch.float32)
            newp = p.to(torch.float32) - lr * delta
            return newp.to(p.dtype), m2, v2

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            flat_g, tree_util.leaves(state.m), tree_util.leaves(state.v),
            tree_util.leaves(params))]
        newp = tree_util.unflatten(params, (o[0] for o in out))
        newm = tree_util.unflatten(params, (o[1] for o in out))
        newv = tree_util.unflatten(params, (o[2] for o in out))
        return newp, AdamWState(step=step, m=newm, v=newv), gnorm
