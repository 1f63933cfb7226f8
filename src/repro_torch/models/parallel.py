"""Tensor- and expert-parallel execution on a (data, model) mesh: the
partition specs, the collectives with their gradients, and the placement
of a full tree onto the mesh and back.

Under GSPMD a sharded JAX step is ONE program and the partitioner inserts
every collective.  A torch rank runs its own shard, so each reduction over
the ``model`` axis is written out, Megatron-style, as two autograd
operators:

* ``copy_to_tp`` (*f*): identity forward, all-reduce of the gradient
  backward, on the input of every block whose weights are split (its
  replicated input gets only a partial gradient from this rank's shard);
* ``reduce_from_tp`` (*g*): all-reduce forward, identity backward, on the
  output of a row-parallel product (its output is replicated, and so is
  its gradient).

``torch.distributed.nn.functional.all_reduce`` would all-reduce the
gradient of *g* too, multiplying it by the model-axis size.  ``f(g(x))``
is an all-reduce both ways: a sum over a split dimension whose result
feeds the split computation again (the gated norm of a Mamba-2 mixer).

Every collective here is counted (``collective_counts``) with its host
time, and its payload bytes under the JAX package's kinds
(``collective_bytes``: the counterpart of its HLO parser,
``collective_bytes_from_hlo``; the port has no HLO, so this is the record
of what the rank's program issued).  Over a one-rank group each is an
identity.  Under ``remat_save_collectives`` the forward all-reduces of a checkpointed layer
are recorded, and its recomputation in the backward replays them instead
of running them again (``collective_tape``, the ``context_fn`` of
``torch.utils.checkpoint``; the JAX package names them ``tp_psum_out`` and
saves them by name).

``Split`` says how a leaf of a full tree is cut into this rank's shard:
contiguous equal parts along one dimension, optionally followed by a
replicated tail (a Mamba-2 ``in_xbc``: its x channels split by heads, its
B and C channels whole on every rank).  ``shard_tree`` / ``gather_tree``
place a full tree by such a layout and gather it back (JAX:
``jax.device_put(tree, NamedSharding)`` / ``np.asarray``).  The layout is
the one decision of what splits: a block runs split exactly where its
layout splits a leaf (``split_ctx``), else replicated on whole weights.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util


def _canonical(part):
    """One dimension's entry as ``PartitionSpec`` stores it: a sequence of
    one axis name is that name, an empty one None (replicated)."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class P(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per dimension,
    an axis name, a tuple of names or None (replicated).  A tuple, so a
    spec tree compares with the JAX package's as nested tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` in axis order (JAX ``mesh.shape``)."""
    return {a: int(mesh.size(i)) for i, a in enumerate(mesh.mesh_dim_names)}


# ---------------------------------------------------------------------------
# Collective counters
# ---------------------------------------------------------------------------
# the JAX package's collective kinds (``dryrun.collective_bytes_from_hlo``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"tp_all_reduce": "all-reduce", "tp_all_gather": "all-gather",
         "dp_all_reduce": "all-reduce", "dp_all_gather": "all-gather"}
_COUNTS = {"tp_all_reduce": 0, "tp_all_gather": 0, "dp_all_reduce": 0,
           "dp_all_gather": 0, "host_s": 0.0}
_BYTES = dict.fromkeys(COLLECTIVES, 0)
_ISSUED = dict.fromkeys(COLLECTIVES, 0)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0.0 if k == "host_s" else 0
    for k in COLLECTIVES:
        _BYTES[k] = _ISSUED[k] = 0


def collective_counts() -> dict:
    """Collectives issued since the last reset: model-axis all-reduces and
    all-gathers, data-axis all-reduces and all-gathers (ZeRO-1's
    parameters), and their summed host seconds (the call, not the device
    time)."""
    return dict(_COUNTS)


def collective_summary(bytes_by_kind: dict, counts: dict) -> dict:
    """The JAX package's collective record from bytes and counts by kind:
    each kind's bytes, ``weighted`` (a ring all-reduce moves about twice
    its payload) and ``total``, and ``counts``."""
    out = {k: float(bytes_by_kind.get(k, 0)) for k in COLLECTIVES}
    out["weighted"] = (2.0 * out["all-reduce"] + out["all-gather"]
                       + out["reduce-scatter"] + out["all-to-all"]
                       + out["collective-permute"])
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = {k: int(counts.get(k, 0)) for k in COLLECTIVES}
    return out


def collective_bytes() -> dict:
    """What this rank issued since the last reset, as the JAX package
    records a compiled program's collectives: the payload a rank holds
    after each (an all-reduce's tensor, an all-gather's gathered block).
    The port has no HLO to parse: this is the record of the collectives
    its program actually called."""
    return collective_summary(_BYTES, _ISSUED)


def _timed(kind: str, fn, nbytes: int):
    t0 = time.perf_counter()
    out = fn()
    _COUNTS["host_s"] += time.perf_counter() - t0
    _COUNTS[kind] += 1
    _BYTES[_KIND[kind]] += nbytes
    _ISSUED[_KIND[kind]] += 1
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduced(x: torch.Tensor, group, kind: str, op=dist.ReduceOp.SUM):
    """A new tensor: ``x`` reduced over ``group`` (``x`` is untouched)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)

    def run():
        dist.all_reduce(out, op=op, group=group)
        return out
    return _timed(kind, run, _nbytes(out))


def gathered_parts(x: torch.Tensor, group, kind: str) -> list:
    """Every rank of ``group``'s ``x`` (all of one shape), in group-rank
    order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    _timed(kind, lambda: dist.all_gather(parts, x.contiguous(), group=group),
           len(parts) * _nbytes(x))
    return parts


# ---------------------------------------------------------------------------
# Recording and replaying forward all-reduces under remat
# ---------------------------------------------------------------------------
_TAPE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tp_tape",
                                                       default=None)


@contextlib.contextmanager
def _tape(mode: str, saved: list):
    token = _TAPE.set({"mode": mode, "saved": saved, "i": 0})
    try:
        yield
    finally:
        _TAPE.reset(token)


def collective_tape():
    """``context_fn`` for ``torch.utils.checkpoint``: the layer's forward
    records each model-axis all-reduce's output, and its recomputation in
    the backward takes them back in order instead of reducing again."""
    saved: list = []
    return _tape("record", saved), _tape("replay", saved)


def tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    tape = _TAPE.get()
    if tape is not None and tape["mode"] == "replay":
        out = tape["saved"][tape["i"]]
        tape["i"] += 1
        return out.detach()
    out = all_reduced(x, group, "tp_all_reduce")
    if tape is not None:
        tape["saved"].append(out.detach())
    return out


# ---------------------------------------------------------------------------
# The autograd operators
# ---------------------------------------------------------------------------
class _Copy(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduced(grad, ctx.group, "tp_all_reduce"), None


class _Reduce(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        return torch.cat(gathered_parts(x, group, "tp_all_gather"), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _DataMean(torch.autograd.Function):
    """The data group's mean as the value, this rank's own term as the
    gradient (the step averages the gradients over the group after)."""

    @staticmethod
    def forward(ctx, x, group, n):
        return all_reduced(x, group, "dp_all_reduce") / n

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """f over ``ctx``'s model axis.  Over one rank it is the identity both
    ways and adds no node to the graph: a node would regroup the sum of
    the gradients that reach ``x``, and the bits with it."""
    if ctx is None or ctx.tp_size == 1:
        return x
    return _Copy.apply(x, ctx.tp_group)


def reduce_from_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """g over ``ctx``'s model axis (the identity where it has none)."""
    if ctx is None or ctx.tp_group is None:
        return x
    return _Reduce.apply(x, ctx.tp_group)


def sum_over_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """``f(g(x))``: a sum over a split dimension that feeds the split
    computation again, all-reduced forward and backward."""
    return copy_to_tp(reduce_from_tp(x, ctx), ctx)


def gather_from_tp(x: torch.Tensor, ctx, dim: int = -1) -> torch.Tensor:
    """The model axis's shards of ``x`` concatenated along ``dim``."""
    if ctx is None or ctx.tp_group is None:
        return x
    return _Gather.apply(x, ctx.tp_group, dim % x.ndim)


def max_over_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` maxed over the model axis, outside autograd."""
    if ctx is None or ctx.tp_group is None:
        return x.detach()
    return all_reduced(x, ctx.tp_group, "tp_all_reduce", dist.ReduceOp.MAX)


def mean_over_dp(x: torch.Tensor, ctx) -> torch.Tensor:
    """The data group's mean of ``x`` (a scalar a rank) with this rank's
    gradient; ``x`` itself without ``ctx``."""
    if ctx is None:
        return x
    return _DataMean.apply(x, ctx.dp_group, ctx.dp_size)


def average_over_dp(tree, ctx):
    """Each leaf of a gradient tree averaged over the data group, in
    float32, cast back to its dtype (exact over one rank)."""
    if ctx is None:
        return tree
    inv = 1.0 / ctx.dp_size

    def avg(g):
        acc = g.to(torch.float32)
        out = all_reduced(acc, ctx.dp_group, "dp_all_reduce")
        return (out * inv).to(g.dtype)
    return tree_util.tree_map(avg, tree)


# ---------------------------------------------------------------------------
# Layouts: a full tree's leaves cut into this rank's shards
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split along ``dim`` into the model axis's equal contiguous
    parts; with ``head``, only its first ``head`` elements along ``dim``
    split, and the rest follow whole on every rank."""
    dim: int
    head: int | None = None

    def shifted(self, by: int = 1) -> "Split":
        """The same split of a leaf stacked under ``by`` new leading
        dimensions."""
        return Split(self.dim + by, self.head)

    def local(self, full: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
        n = full.shape[self.dim] if self.head is None else self.head
        if n % tp:
            raise ValueError(f"Split: {n} does not divide over {tp} ranks")
        c = n // tp
        part = full.narrow(self.dim, rank * c, c)
        if self.head is not None and self.head < full.shape[self.dim]:
            part = torch.cat([part, full.narrow(
                self.dim, self.head, full.shape[self.dim] - self.head)],
                dim=self.dim)
        return part.contiguous()

    def parts(self, local: torch.Tensor, tp: int):
        """(the split part, the replicated tail or None) of this rank's
        shard ``local``."""
        if self.head is None:
            return local, None
        c = self.head // tp
        return (local.narrow(self.dim, 0, c),
                local.narrow(self.dim, c, local.shape[self.dim] - c))

    def gather(self, local: torch.Tensor, ctx) -> torch.Tensor:
        parts = gathered_parts(local, ctx.tp_group, "tp_all_gather")
        if self.head is None:
            return torch.cat(parts, dim=self.dim)
        c = self.head // ctx.tp_size
        tail = local.shape[self.dim] - c
        return torch.cat([p.narrow(self.dim, 0, c) for p in parts]
                         + [parts[0].narrow(self.dim, c, tail)], dim=self.dim)


def stack_layout(layout, by: int = 1):
    """A per-layer layout for leaves stacked under ``by`` leading axes."""
    return map_layout(lambda s: s.shifted(by), layout)


def map_layout(fn, layout):
    if isinstance(layout, dict):
        return {k: map_layout(fn, v) for k, v in layout.items()}
    if isinstance(layout, list):
        return [map_layout(fn, v) for v in layout]
    return None if layout is None else fn(layout)


def _walk(fn, tree, layout):
    """``fn(leaf, split-or-None)`` over a tree and its layout; a layout
    that stops above a subtree (None) covers it whole."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, None if layout is None else layout[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_walk(fn, v, None if layout is None else layout[i])
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    if tree is None:
        return None
    return fn(tree, layout)


def shard_tree(tree, layout, ctx):
    """This rank's shards of a full tree (leaves not split pass as they
    are)."""
    if ctx is None or ctx.tp_size == 1:
        return tree
    return _walk(lambda a, s: a if s is None else s.local(
        a, ctx.tp_size, ctx.tp_rank), tree, layout)


def gather_tree(tree, layout, ctx):
    """The full tree from every rank's shards (a collective: every rank of
    the model axis calls it)."""
    if ctx is None or ctx.tp_size == 1:
        return tree
    return _walk(lambda a, s: a if s is None else s.gather(a, ctx), tree,
                 layout)


def leaf_splits(tree, layout) -> list:
    """For each leaf of ``tree`` in flatten order: its ``Split``, or None
    where it is whole."""
    marks = _walk(lambda a, s: s or False, tree, layout)
    return [s or None for s in tree_util.leaves(marks)]


def split_ctx(ctx, layout_of, *args):
    """``ctx`` where the block's layout, ``layout_of(*args, tp)``, splits a
    leaf over ``ctx``'s model axis (the block runs split on its shard),
    else None (it runs replicated on whole weights)."""
    if ctx is None:
        return None
    lay = layout_of(*args, ctx.tp_size)
    found = []
    map_layout(found.append, lay)
    return ctx if found else None
