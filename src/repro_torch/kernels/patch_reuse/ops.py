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

from repro_torch.kernels.patch_reuse.kernel import patch_delta_kernel
from repro_torch.kernels.patch_reuse.ref import patch_delta_ref


def patch_delta(x: torch.Tensor, x_ref: torch.Tensor, patch: int,
                threshold: float, use_kernel: bool = True):
    """(B, T, C) tokens vs cached reference -> (delta, active) per patch.

    ``delta`` is the (B, T/patch) float32 max-abs difference, ``active``
    the bool bitmap ``delta >= threshold`` (all True at threshold 0).
    ``use_kernel`` False takes the plain version on any device.
    """
    b, t, c = x.shape
    if t % patch:
        raise ValueError(f"patch_delta: T={t} is not a multiple of patch "
                         f"{patch}")
    if use_kernel and x.is_cuda:
        def fold(a):
            return a.to(torch.float32).reshape(b, t // patch,
                                               patch * c).contiguous()
        delta = patch_delta_kernel(fold(x), fold(x_ref))
    else:
        delta = patch_delta_ref(x, x_ref, patch)
    return delta, delta >= threshold


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
