"""FLOP counting of one call on fake tensors (port of
``repro.launch.flops``).

The JAX package walks a jaxpr and multiplies each ``scan`` / ``while``
body by its trip count, because XLA's ``cost_analysis`` counts a loop
body once.  The port's programs are eager Python: a layer loop, the
microbatch loop and the SSD chunk recurrence are Python loops whose every
iteration dispatches its ops, and ``torch.utils.checkpoint`` dispatches
its recomputation in the backward as it runs.  So counting what is
dispatched, with ``torch.utils.flop_counter``'s formulas (``FlopCounter``,
a lean ``FlopCounterMode``), is already loop- and remat-aware; no trip
count is needed.  Under ``FakeTensorMode`` nothing is computed or
allocated, so a full-width step costs only the time of its Python.

Convention: matmul / conv FLOPs only (2 x MACs), the JAX package's.  The
products that the JAX package computes as ``dot_general``s with no summed
index and the port as broadcast multiplies (the SSD's einsums in
``models/ssm.py``, whose pairs follow JAX's contraction order) are the
custom ops ``ssm.product`` / ``product_grad``, counted the JAX way by
their formulas (``ssm.SSD_PRODUCT_FLOPS``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_util


def _to_fake(args, mode: FakeTensorMode):
    """``args`` with every tensor made fake in ``mode``, a meta tensor as
    an uninitialised fake on the CPU."""
    def conv(a):
        if not isinstance(a, torch.Tensor):
            return a
        if a.is_meta:
            with mode:
                return torch.empty(a.shape, dtype=a.dtype)
        return mode.from_tensor(a)
    return tree_util.unflatten(args, [conv(a) for a in
                                      tree_util.leaves(args)])


def _registry() -> dict:
    """torch's flop formulas with the port's (``ssm.SSD_PRODUCT_FLOPS``),
    keyed by op packet, each taking the op's arguments and ``out_val``."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper

    from repro_torch.models.ssm import SSD_PRODUCT_FLOPS
    return {**flop_registry, **{k: shape_wrapper(v) for k, v in
                                SSD_PRODUCT_FLOPS.items()}}


class FlopCounter(TorchDispatchMode):
    """Matmul / conv FLOPs of the ops dispatched while it is active
    (``total``): ``FlopCounterMode``'s formulas and its dispatch rule (an
    op is decomposed where it can be, and its parts counted), without its
    per-module tables.  ``seen`` is a hook for subclasses, called on every
    op that ran."""

    def __init__(self):
        super().__init__()
        self.registry = _registry()
        self.total = 0

    def seen(self, func, args, kwargs, out) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if func is not _DEVICE:            # FlopCounterMode's rule
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.total += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        self.seen(func, args, kwargs, out)
        return out


_DEVICE = torch.ops.prim.device.default


def flops_of_callable(fn, *args) -> float:
    """Matmul / conv FLOPs of one call ``fn(*args)``, forward plus the
    backward where ``fn`` differentiates, run on fake tensors.  ``args``
    are trees of tensors (made fake; a meta tensor becomes a fake CPU
    tensor)."""
    mode = FakeTensorMode()
    fake = _to_fake(args, mode)
    with mode, FlopCounter() as fc:
        fn(*fake)
    return float(fc.total)
