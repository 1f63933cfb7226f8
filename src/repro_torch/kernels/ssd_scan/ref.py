"""Plain PyTorch version of the SSD scan kernel (port of the JAX
``ssd_scan_ref``), on the folded-head contract of the TPU kernel."""
from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int = 128):
    """x (BH, T, p) pre-multiplied by dt, dA (BH, T), B/C (BH, T, n)
    -> (y (BH, T, p), final state (BH, p, n)), float32.

    The direct sequential recurrence, the textbook SSM semantics:
        s_t = exp(dA_t) * s_{t-1} + x_t^T B_t      (p, n)
        y_t = s_t C_t^T                            (p,)
    ``chunk`` is accepted for the kernel's signature and not used: the
    recurrence has no chunks.
    """
    del chunk
    bh, t, p = x.shape
    n = B.shape[-1]
    x, dA, B, C = (a.to(torch.float32) for a in (x, dA, B, C))
    decay = torch.exp(dA)
    s = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        s = decay[:, i, None, None] * s + x[:, i, :, None] * B[:, i, None, :]
        ys.append(torch.einsum("bpn,bn->bp", s, C[:, i]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, p))
    return y, s
