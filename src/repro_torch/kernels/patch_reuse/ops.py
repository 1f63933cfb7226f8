"""Public temporal-reuse ops: the patch delta and the gather/scatter row
plans (port of ``repro.kernels.patch_reuse.ops``).

``patch_delta`` runs the hand-written kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor; there is no fallback from one to
the other.  The plan helpers are index arithmetic shared by every route:
the UNet gathers the active patch rows, computes on them and scatters
the results over the cached activations.

Exactness: the plan puts ACTIVE patches first in ascending patch index
(stable argsort of the inverted bitmap), so an all-active row gives the
identity permutation and gather -> compute -> scatter returns the dense
result bit for bit.  When the actives exceed the capacity, the
highest-index ones are dropped and fall back to the cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.patch_reuse.kernel import (BLOCK_SLICES_CHOICES,
                                                    check_block_slices,
                                                    patch_delta_kernel)
from repro_torch.kernels.patch_reuse.ref import patch_delta_ref


def patch_delta(x: torch.Tensor, x_ref: torch.Tensor, patch: int,
                threshold: float, use_kernel: bool = True,
                bp: int | None = None):
    """(B, T, C) tokens vs cached reference -> (delta, active) per patch.

    ``delta`` is the (B, T/patch) float32 max-abs difference, ``active``
    the bool bitmap ``delta >= threshold`` (all True at threshold 0).
    ``use_kernel`` False takes the plain version on any device.  ``bp`` is
    the kernel's slices of one patch row a block
    (``kernel.check_block_slices``; ``None``: 8); it moves no bit, and the
    plain version has none.
    """
    check_block_slices(bp)
    b, t, c = x.shape
    if t % patch:
        raise ValueError(f"patch_delta: T={t} is not a multiple of patch "
                         f"{patch}")
    if use_kernel and x.is_cuda:
        def fold(a):
            return a.to(torch.float32).reshape(b, t // patch,
                                               patch * c).contiguous()
        delta = patch_delta_kernel(fold(x), fold(x_ref), bp=bp)
    else:
        delta = patch_delta_ref(x, x_ref, patch)
    return delta, delta >= threshold


# ---------------------------------------------------------------------------
# Autotune hooks (repro_torch.kernels.autotune): geometry = (b, t, c, patch)
# ---------------------------------------------------------------------------
AUTOTUNE_KNOBS = ("reuse_block_patches",)


def autotune_candidates(geom: tuple) -> tuple:
    """Every chunk the kernel takes, 8 (its launch rule) among them.

    The JAX kernel groups whole patches into a block; the CUDA kernel
    splits each patch row (patch * C values) over blocks instead, so here
    ``reuse_block_patches`` counts the slices of 256 values
    (``kernel.SLICE``) of one patch row that a block takes (8, 2048
    values, by default).
    """
    return tuple({"reuse_block_patches": s} for s in BLOCK_SLICES_CHOICES)


def autotune_probe(geom: tuple, blocks: dict, *, device=None):
    """(fn, input sets) the autotuner times for one block config."""
    b, t, c, patch = geom
    dev = runtime.resolve_device(device)
    n = runtime.rotation(2 * 4 * b * t * c, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, b, t, c), device=dev, generator=gen)
    x_ref = x + 1e-4 * torch.randn((n, b, t, c), device=dev, generator=gen)

    def fn(xs, rs):
        return patch_delta(xs, rs, patch, 1e-3,
                           bp=blocks["reuse_block_patches"])
    return fn, [(x[i], x_ref[i]) for i in range(n)]


def reuse_plan(active: torch.Tensor, cap: int):
    """(B, P) active bitmap -> gather plan (order, gate), each (B, cap).

    ``order`` lists patch indices, actives first in ascending order (a
    stable sort, so all-active rows get the identity); ``gate`` marks the
    slots that hold an active patch.
    """
    key = torch.logical_not(active).to(torch.uint8)
    order = torch.argsort(key, dim=1, stable=True)[:, :cap]
    gate = torch.gather(active, 1, order)
    return order, gate


def plan_token_rows(order: torch.Tensor, patch: int) -> torch.Tensor:
    """Patch-index plan -> token-row indices (B, cap*patch), plan-major."""
    b, k = order.shape
    rows = order[:, :, None] * patch + torch.arange(
        patch, dtype=order.dtype, device=order.device)[None, None, :]
    return rows.reshape(b, k * patch)


def _row_index(rows: torch.Tensor, c: int) -> torch.Tensor:
    return rows[:, :, None].expand(-1, -1, c)


def gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, T, C) tokens + (B, R) row ids -> (B, R, C) gathered rows."""
    return torch.gather(x, 1, _row_index(rows, x.shape[-1]))


def scatter_rows(base: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor,
                 gate_rows: torch.Tensor) -> torch.Tensor:
    """A copy of the cache ``base`` (B, T, C) with the gated rows of
    ``values`` (B, R, C) written at ``rows`` (B, R).

    Ungated slots keep the cache payload even though their row index
    names a real token.  Plan rows are unique per batch row, so the
    scatter is a deterministic copy; ``base`` itself is not modified.
    """
    idx = _row_index(rows, base.shape[-1])
    cur = torch.gather(base, 1, idx)
    vals = torch.where(gate_rows[:, :, None], values, cur)
    return base.scatter(1, idx, vals)
