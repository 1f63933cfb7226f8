"""Learning-rate schedules (port of ``repro.optim.schedules``).

Each schedule maps a step tensor to a float32 learning-rate tensor on its
device, in float32 throughout, as the JAX package computes it.  The
constants are folded as XLA folds them inside ``jit`` (the trainer's step
is jitted there): ``s / total`` is ``s * float32(1 / total)``, and the
warm-up ``base_lr * s / warmup`` is ``s * float32(base_lr * float32(1 /
warmup))`` (ROADMAP.md, Queue 3 item 2).  XLA's CPU backend also fuses
the cosine's ``a * 0.45 + 0.1`` into one FMA, where torch rounds twice:
the two packages then differ by an ulp on some steps.
"""
from __future__ import annotations

import math

import torch


def _f32(v: float) -> float:
    """``v`` rounded to float32."""
    return torch.tensor(v, dtype=torch.float32).item()


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    inv_total = 1.0 / total_steps

    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) * inv_total, 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac)
                          * 0.5 * (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)
    slope = _f32(_f32(base_lr) * _f32(1.0 / max(warmup, 1)))

    def lr(step: torch.Tensor) -> torch.Tensor:
        warm = step.to(torch.float32) * slope
        return torch.where(step <= warmup, warm, cos(step - warmup))
    return lr
