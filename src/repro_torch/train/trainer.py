"""Train step factory and the fault-tolerant training loop (port of
``repro.train.trainer``).

* checkpoint and restart: periodic atomic checkpoints of (params,
  optimiser state, residual) with the data state in their meta;
  ``Trainer.run`` resumes from the latest complete step;
* fault injection: ``failure_hook`` lets a caller kill the loop at any
  step, and a fresh ``Trainer`` resumes it (bit for bit on the CPU);
* the data contract is pure in (seed, step) (``data/pipeline.py``), so any
  host can regenerate a slow host's shard;
* gradient compression: int8 with error feedback (``optim/compression.py``);
* ZeRO-1 and ZeRO-3 over the data axes (``make_train_step(zero1=,
  zero3=)``).

The step runs eagerly (no ``torch.compile``).  On a (data, model) mesh
(``ctx``, a ``models.layers.ShardCtx``) each rank steps its rows and its
parameter shard: the loss is the data group's mean, the gradients are
averaged over the data group before the int8 compression (which the JAX
package applies after its reduction too), and AdamW's moments follow the
shards.  ``Trainer(ctx=)`` writes checkpoints in the unsharded layout
(full leaves gathered over the model axis, written once) and shards what
it loads by the current mesh, so a run saved at one mesh shape resumes at
another.  A model with ``use_ssd_kernel=True`` cannot train: the kernel
has no backward, and its route raises.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataState
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.parallel import (average_over_dp, gather_tree,
                                         leaf_splits, shard_tree)
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import (AdamWState, Zero, zero_dims,
                                     zero_gather, zero_slice)
from repro_torch.optim.compression import error_feedback_update


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    log_every: int = 10
    grad_compression: bool = False
    aux_coef: float = 0.01      # the weight of the moe load-balance loss


def _value_and_grad(params, batch, cfg: ArchConfig, aux_coef: float = 0.01,
                    remat: bool = True, ctx=None, zero=None):
    """(loss, metrics), gradients in each parameter's dtype (as
    ``jax.value_and_grad`` of ``loss_fn``).  The parameters are read
    through detached views that require a gradient: nothing is copied,
    and the caller's tensors are left as they are.  A leaf the loss does not reach (the
    embedding table of an ``embedding_input`` model) gets zeros.
    ``zero`` (ZeRO-3): ``params`` are slices, and the gradient of each
    sliced leaf is already the data group's mean, sliced."""
    leaves = [p.detach().requires_grad_() for p in tree_util.leaves(params)]
    with torch.enable_grad():
        lval, metrics = T.loss_fn(tree_util.unflatten(params, leaves), batch,
                                  cfg, aux_coef, remat, ctx=ctx, zero=zero)
        grads = torch.autograd.grad(lval, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (lval.detach(), metrics), tree_util.unflatten(params, grads)


def state_layout(cfg: ArchConfig, ctx, grad_compression: bool = False):
    """The split of a train state (params, AdamWState, residual) over
    ``ctx``'s model axis: the moments and a residual tree follow the
    parameters."""
    pl = T.param_layout(cfg, ctx.tp_size if ctx is not None else 1)
    return (pl, AdamWState(step=None, m=pl, v=pl),
            pl if grad_compression else None)


def zero_plan(params, cfg: ArchConfig, ctx) -> Zero | None:
    """ZeRO-1's split of the moments of ``params`` (this rank's model
    shard) over ``ctx``'s data group; None over one data rank (nothing to
    split)."""
    if ctx.dp_size == 1:
        return None
    split = leaf_splits(params, T.param_layout(cfg, ctx.tp_size))
    return Zero(zero_dims(params, ctx.dp_size, split), ctx.dp_rank,
                ctx.dp_size, ctx.dp_group)


def zero3_plan(cfg: ArchConfig, ctx) -> Zero:
    """ZeRO-3's split of the parameters, gradients and moments over
    ``ctx``'s data group: ``zero_dims`` of the model-axis shard's shapes
    (abstract, no storage), never of the slices a state holds.  Over one
    data rank too: every leaf's slice is then the whole leaf, and each use
    still passes through ``gather_over_dp`` on the one-rank group."""
    shard = T.shard_params(T.abstract_params(cfg), cfg, ctx)
    split = leaf_splits(shard, T.param_layout(cfg, ctx.tp_size))
    return Zero(zero_dims(shard, ctx.dp_size, split), ctx.dp_rank,
                ctx.dp_size, ctx.dp_group, sliced=True)


def zero3_slices(state, zero: Zero):
    """This data rank's ZeRO-3 slices of a train state (params, AdamWState,
    residual) in the model-axis layout (``state_layout``): copies, so the
    whole state can be freed; over one data rank the leaves themselves."""
    def cut(tree):
        return tree_util.unflatten(tree, (
            a if zero.size == 1 else zero_slice(a, d, zero).clone(
                memory_format=torch.contiguous_format)
            for a, d in zip(tree_util.leaves(tree), zero.dims)))
    params, opt_state, residual = state
    return (cut(params), opt_state._replace(m=cut(opt_state.m),
                                            v=cut(opt_state.v)), residual)


def zero3_gather(state, zero: Zero):
    """The model-axis layout of a ZeRO-3 train state: its slices gathered
    over the data group (a collective)."""
    params, opt_state, residual = state
    return (zero_gather(params, zero), opt_state._replace(
        m=zero_gather(opt_state.m, zero), v=zero_gather(opt_state.v, zero)),
        residual)


def _average(grads, ctx, zero: Zero | None):
    """The data group's mean of each leaf of ``grads`` (ZeRO-3: of the
    whole leaves only; a sliced leaf's gradient is the mean already)."""
    if zero is None:
        return average_over_dp(grads, ctx)
    flat = tree_util.leaves(grads)
    whole = iter(average_over_dp([g for g, d in zip(flat, zero.dims)
                                  if d is None], ctx))
    return tree_util.unflatten(grads, (next(whole) if d is None else g
                                       for g, d in zip(flat, zero.dims)))


def _reduced_grads(params, batch, cfg: ArchConfig, aux_coef: float = 0.01,
                   num_microbatches: int = 1, ctx=None, zero=None,
                   remat: bool = True):
    """(loss, metrics, gradients) of one step before the update: the
    gradients summed over ``num_microbatches`` and averaged over the data
    group (``make_train_step``)."""
    if num_microbatches == 1:
        (lval, metrics), grads = _value_and_grad(params, batch, cfg,
                                                 aux_coef, remat, ctx, zero)
    else:
        m = num_microbatches
        parts = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                 for k, v in batch.items()}
        gsum = tree_util.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        lsum = None
        for i in range(m):
            (lv, _), g = _value_and_grad(
                params, {k: v[i] for k, v in parts.items()}, cfg,
                aux_coef, remat, ctx, zero)
            gsum = tree_util.tree_map(
                lambda a, b: a + b.to(torch.float32), gsum, g)
            lsum = lv if lsum is None else lsum + lv
        # XLA folds the JAX package's "/ m" into a product by 1 / m
        inv_m = 1.0 / m
        grads = tree_util.tree_map(lambda g: g * inv_m, gsum)
        lval = lsum * inv_m
        metrics = {"nll": lval, "aux": torch.zeros_like(lval)}
    return lval, metrics, _average(grads, ctx, zero)


def make_train_step(cfg: ArchConfig, opt: AdamW,
                    grad_compression: bool = False,
                    num_microbatches: int = 1, aux_coef: float = 0.01,
                    ctx=None, zero1: bool = False, zero3: bool = False):
    """-> f(state, batch) -> (state, metrics); ``state`` is (params,
    AdamWState, residual), ``metrics`` holds ``loss``, ``nll``, ``aux``
    and ``grad_norm`` (float32 scalars on the device).  The loss is
    ``loss_fn``'s, ``nll + aux_coef * aux``.

    ``num_microbatches`` m > 1 accumulates gradients: the batch is split
    along its leading axis, the m gradients are summed in float32 in
    order and divided by m, and ``aux`` is reported as 0 (as the JAX
    package does); live activations are those of one microbatch.

    ``ctx``: ``state`` holds this rank's shards (``state_layout``) and
    ``batch`` its rows (``SyntheticLMDataset.rank_batch_at``); microbatches
    split the rows, the loss and the gradients are the data group's means,
    and the grad norm is that of the whole gradient.

    The layout kept between steps, with ``ctx``: by default every data
    rank holds its model shard of the parameters and the moments whole.
    ``zero1`` (ZeRO-1): the moments are this data rank's slices
    (``zero_plan``, ``AdamW.init(zero=)``) and the parameters whole, gathered
    over the data group after each update; over one data rank it changes
    nothing.  ``zero3`` (ZeRO-3, the JAX dry-run's ``fsdp``): the
    parameters are slices as well (``zero3_plan``, ``zero3_slices``):
    each layer gathers its leaves where it is used and reduce-scatters
    their gradients (``parallel.gather_over_dp``), the leaves no data
    dimension divides stay whole with their gradients all-reduced, and
    the update returns slices.  Over one data rank the gathers and
    scatters still run, on the one-rank group.  Not with
    ``grad_compression``.
    """
    if zero1 and ctx is None:
        raise ValueError("zero1 shards the moments over a mesh: give ctx")
    if zero3 and ctx is None:
        raise ValueError("zero3 shards the parameters over a mesh: give ctx")
    if zero1 and zero3:
        raise ValueError("zero1 and zero3: give one (ZeRO-3 slices the "
                         "moments as ZeRO-1 does)")
    if zero3 and grad_compression:
        raise ValueError("zero3 with grad_compression: no JAX entry point "
                         "compresses a data-sharded gradient, and the int8 "
                         "scale is per whole leaf, not per slice")
    layout = T.param_layout(cfg, ctx.tp_size) if ctx is not None else None
    tp_group = ctx.tp_group if ctx is not None else None
    plan = zero3_plan(cfg, ctx) if zero3 else None

    def step_fn(state, batch):
        params, opt_state, residual = state
        split = (leaf_splits(params, layout) if layout is not None
                 else None)
        lval, metrics, grads = _reduced_grads(
            params, batch, cfg, aux_coef, num_microbatches, ctx, plan)
        if grad_compression:
            grads, residual = error_feedback_update(grads, residual, split,
                                                    tp_group)
        zero = plan if zero3 else (zero_plan(params, cfg, ctx) if zero1
                                   else None)
        new_params, new_opt, gnorm = opt.update(
            grads, opt_state, params, split, tp_group, zero)
        metrics = dict(metrics, loss=lval, grad_norm=gnorm)
        return (new_params, new_opt, residual), metrics

    return step_fn


class Trainer:
    def __init__(self, cfg: ArchConfig, dataset, opt: AdamW,
                 tc: TrainConfig,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device=None, ctx=None):
        self.cfg, self.dataset, self.opt, self.tc = cfg, dataset, opt, tc
        self.failure_hook = failure_hook
        self.ctx = ctx
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, opt, tc.grad_compression,
                                       aux_coef=tc.aux_coef, ctx=ctx)
        self.layout = state_layout(cfg, ctx, tc.grad_compression)

    def _lead(self) -> bool:
        """Prints and writes: the only rank without a mesh, rank 0 on
        one."""
        return self.ctx is None or dist.get_rank() == 0

    def _fresh_full_state(self, generator: torch.Generator):
        """The unsharded fresh state (every rank draws the same)."""
        params = T.init_params(generator, self.cfg)
        opt_state = self.opt.init(params)
        residual = (tree_util.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            if self.tc.grad_compression
            else torch.zeros((), dtype=torch.float32, device=self.device))
        return params, opt_state, residual

    def _fresh_state(self, generator: torch.Generator):
        """This rank's shard of a fresh state."""
        return shard_tree(self._fresh_full_state(generator), self.layout,
                          self.ctx)

    def save(self, step: int, state, data: DataState) -> None:
        """A checkpoint of ``state`` in the unsharded layout: under a mesh
        its leaves are gathered over the model axis and rank 0 writes."""
        full = gather_tree(state, self.layout, self.ctx)
        if self._lead():
            save_checkpoint(
                self.tc.checkpoint_dir, step, full,
                meta={"data_seed": data.seed, "data_step": data.step,
                      "arch": self.cfg.name})
        if self.ctx is not None:
            dist.barrier()

    def run(self, generator: Optional[torch.Generator] = None,
            resume: bool = True):
        """Train to ``tc.steps`` from a fresh state (``generator``; seed 0
        on the trainer's device by default), or from the latest checkpoint
        under ``tc.checkpoint_dir`` when ``resume``.  -> (state, history
        of (step, loss))."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        state = self._fresh_full_state(generator)
        data = DataState(seed=self.dataset.seed, step=0)
        start = 0
        if resume:
            last = latest_step(self.tc.checkpoint_dir)
            if last is not None:
                state, meta = load_checkpoint(self.tc.checkpoint_dir, last,
                                              state)
                data = DataState(seed=meta["data_seed"],
                                 step=meta["data_step"])
                start = last
        state = shard_tree(state, self.layout, self.ctx)

        history = []
        for step in range(start, self.tc.steps):
            if self.failure_hook is not None:
                self.failure_hook(step)      # may raise (simulated node loss)
            batch = self.dataset.rank_batch_at(data.step, self.ctx,
                                               device=self.device)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            data = data.advance()
            if (step + 1) % self.tc.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                history.append((step + 1, loss))
                if self._lead():
                    print(f"step {step + 1:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"dt {time.perf_counter() - t0:.3f}s")
            if (step + 1) % self.tc.checkpoint_every == 0 \
                    or step + 1 == self.tc.steps:
                self.save(step + 1, state, data)
        return state, history
