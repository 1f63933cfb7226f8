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

ZeRO-1 (``Zero``, as the JAX dry-run shards AdamW's state): the moments
of each leaf are further split over the data group along one dimension
(``zero_dims``), each data rank updates its slice of the moments and of
the parameter, and the new parameter is all-gathered over the data group.
The update is elementwise, so a slice's values are those of the whole
update; the clip norm is still the whole gradient's (every rank holds the
data-averaged gradient of its model shard).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.models.parallel import all_reduced, gathered_parts


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: dict
    v: dict


class Zero(NamedTuple):
    """ZeRO-1's split of the moments over a data group: for each leaf in
    flatten order the dimension it splits along, or None (whole on every
    data rank); this rank's index in the group and its size."""
    dims: tuple
    rank: int
    size: int
    group: object


def zero_dims(params, dp: int, split=None) -> tuple:
    """For each leaf of ``params`` (this rank's model shard) in flatten
    order: the first dimension that ``dp`` divides (and is at least
    ``dp``), other than the one its model-axis ``Split`` cuts; None where
    no dimension qualifies (the JAX dry-run's ``zero_spec`` rule, on the
    executed shard)."""
    out = []
    for i, p in enumerate(tree_util.leaves(params)):
        cut = split[i].dim if split is not None and split[i] else None
        out.append(next((d for d, n in enumerate(p.shape)
                         if d != cut and n % dp == 0 and n >= dp), None))
    return tuple(out)


def zero_slice(t: torch.Tensor, dim, zero: Zero) -> torch.Tensor:
    """This data rank's slice of ``t`` along ``dim`` (``t`` where None)."""
    if dim is None:
        return t
    c = t.shape[dim] // zero.size
    return t.narrow(dim, zero.rank * c, c)


def zero_gather(tree, zero: Zero):
    """Whole leaves from the data group's slices (a collective)."""
    return tree_util.unflatten(tree, (
        a if d is None else torch.cat(
            gathered_parts(a, zero.group, "dp_all_gather"), dim=d)
        for a, d in zip(tree_util.leaves(tree), zero.dims)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params, zero: Zero | None = None) -> AdamWState:
        """Zero moments for ``params``; under ``zero`` this data rank's
        slices of them."""
        flat = tree_util.leaves(params)
        dims = zero.dims if zero is not None else (None,) * len(flat)

        def zeros():
            return tree_util.unflatten(params, (
                torch.zeros_like(zero_slice(p, d, zero), dtype=torch.float32)
                for p, d in zip(flat, dims)))
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
            m=zeros(), v=zeros())

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamWState, params, split=None,
               tp_group=None, zero: Zero | None = None):
        """-> (new params, new state, the global gradient norm before the
        clip).  ``split``: for each leaf in flatten order, its
        ``parallel.Split`` over ``tp_group`` (this rank holds a shard), or
        None (whole).  ``zero``: ``state`` holds this data rank's slices
        of the moments (ZeRO-1); the new parameters are whole."""
        flat_g = tree_util.leaves(grads)

        def sumsq(g):
            return torch.sum(torch.square(g.to(torch.float32)))
        if split is None or not any(split):
            # the global norm, leaf sums added in flatten order
            gnorm = torch.sqrt(sum(sumsq(g) for g in flat_g))
        else:
            tp = dist.get_world_size(tp_group)
            nil = torch.zeros((), dtype=torch.float32,
                              device=flat_g[0].device)
            mine, whole = nil, nil
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

        flat_p = tree_util.leaves(params)
        dims = zero.dims if zero is not None else (None,) * len(flat_p)
        out = [upd(zero_slice(g, d, zero), m, v, zero_slice(p, d, zero))
               for g, m, v, p, d in zip(flat_g, tree_util.leaves(state.m),
                                        tree_util.leaves(state.v), flat_p,
                                        dims)]
        newp = tree_util.unflatten(params, (o[0] for o in out))
        if zero is not None:
            newp = zero_gather(newp, zero)
        newm = tree_util.unflatten(params, (o[1] for o in out))
        newv = tree_util.unflatten(params, (o[2] for o in out))
        return newp, AdamWState(step=step, m=newm, v=newv), gnorm
