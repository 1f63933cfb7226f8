"""Deterministic, resumable, shardable data pipeline (port of
``repro.data.pipeline``).

* every batch is a pure function of (seed, step): checkpoint and restore
  need only the step counter, and any host can regenerate any shard
  (straggler takeover, elastic re-balance);
* ``shard_assignment`` maps a host to contiguous batch rows from the live
  host count;
* the token streams are synthetic (numpy's ``SeedSequence([seed, step,
  row])`` per row), so the integers equal the JAX package's for every
  (seed, step, host, num_hosts).  ``batch_at`` is the interface a
  tokenized-corpus loader would implement.

On a mesh each data rank takes its own equal rows (``rank_batch_at``),
and ``make_batch_specs`` gives the global batch's shapes, dtypes and
partition specs without allocating it (the JAX package's
``ShapeDtypeStruct`` / ``PartitionSpec`` pairs).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass
class DataState:
    """Everything needed to resume the pipeline exactly."""
    seed: int
    step: int

    def advance(self, n: int = 1) -> "DataState":
        return DataState(self.seed, self.step + n)


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embedding_input: bool = False
    d_model: int = 0

    def batch_at(self, step: int, host: int = 0, num_hosts: int = 1,
                 device=None) -> dict:
        """(The host's rows of) batch ``step`` as tensors on ``device``
        (the card by default): ``labels`` int32 (rows, T), and ``tokens``
        int32 (rows, T) or, for an ``embedding_input`` model, ``embeds``
        bfloat16 (rows, T, d_model).

        Pure in (seed, step, global row index): every row has its own
        counter-based stream, so any host regenerates any other host's
        rows bit for bit."""
        device = resolve_device(device)
        lo, hi = shard_assignment(self.global_batch, host, num_hosts)
        rows = hi - lo
        toks = np.empty((rows, self.seq_len), np.int64)
        embs = (np.empty((rows, self.seq_len, self.d_model), np.float32)
                if self.embedding_input else None)
        for r in range(rows):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, lo + r]))
            # Markov-ish stream: token t+1 depends on token t, so a model
            # has signal to fit
            base = rng.integers(0, self.vocab_size)
            steps = rng.integers(0, 17, size=(self.seq_len - 1,)).cumsum()
            toks[r, 0] = base
            toks[r, 1:] = base + steps
            if embs is not None:
                embs[r] = rng.standard_normal(
                    (self.seq_len, self.d_model)).astype(np.float32)
        tokens = (toks % self.vocab_size).astype(np.int32)
        batch = {"labels": torch.from_numpy(
            np.roll(tokens, -1, axis=1)).to(device)}
        if embs is not None:
            batch["embeds"] = torch.from_numpy(embs).to(
                device=device, dtype=torch.bfloat16)
        else:
            batch["tokens"] = torch.from_numpy(tokens).to(device)
        return batch


    def rank_batch_at(self, step: int, ctx=None, device=None) -> dict:
        """This data rank's rows of batch ``step`` under ``ctx`` (a
        ``layers.ShardCtx``; the whole batch without one).  Every rank of
        the data axes holds the same number of rows, so the mean over the
        group of the ranks' row means is the batch mean."""
        if ctx is None:
            return self.batch_at(step, device=device)
        if self.global_batch % ctx.dp_size:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split evenly over {ctx.dp_size} data ranks")
        return self.batch_at(step, ctx.dp_rank, ctx.dp_size, device=device)


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not allocated (JAX: ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def make_batch_specs(cfg, shape, dp_axes) -> dict:
    """{name: (TensorSpec, PartitionSpec)} for one global batch of
    ``shape`` (a ``ShapeConfig``), rows split over ``dp_axes``."""
    from repro_torch.models.parallel import P
    b, t = shape.global_batch, shape.seq_len
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    specs = {"labels": (TensorSpec((b, t), torch.int32), P(dp, None))}
    if cfg.embedding_input:
        specs["embeds"] = (TensorSpec((b, t, cfg.d_model), torch.bfloat16),
                           P(dp, None, None))
    else:
        specs["tokens"] = (TensorSpec((b, t), torch.int32), P(dp, None))
    return specs


def shard_assignment(global_batch: int, host: int, num_hosts: int):
    """Contiguous row range [lo, hi) owned by ``host`` (balanced +-1)."""
    q, r = divmod(global_batch, num_hosts)
    lo = host * q + min(host, r)
    hi = lo + q + (1 if host < r else 0)
    return lo, hi
