"""Public op: fused SSD scan in the model's (B, T, H, P) layout (port of
``repro.kernels.ssd_scan.ops``).

A CUDA tensor goes through the hand-written kernel, a CPU tensor (or
``use_kernel=False``) through the plain sequential recurrence; there is no
fallback from one to the other.  The kernel has no backward: where
autograd records and an input requires a gradient, the kernel route
raises (``use_ssd_kernel=False`` trains through the plain chunked scan).
The kernel reads each batch row's B and C
once per head in place (``heads=h``), where the TPU kernel's contract, which
the plain version keeps, copies them per head.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def pick_chunk(t: int, chunk: int) -> int:
    """The chunk the JAX op picks: ``min(chunk, t)`` halved until it
    divides ``t`` (an odd ``t`` gives 1)."""
    ck = min(chunk, t)
    while t % ck:
        ck //= 2
    return ck


def ssd_scan_fused(x, dt, A, B, C, chunk: int = 128,
                   use_kernel: bool = True):
    """Drop-in for ``models.ssm.ssd_scan`` (single B/C group).

    x (b,t,h,p); dt (b,t,h) post-softplus; A (h,) < 0; B, C (b,t,n).
    Returns (y (b,t,h,p), final_state (b,h,p,n)), float32.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    ck = pick_chunk(t, chunk)

    xdt = (x * dt[..., None]).to(torch.float32)
    dA = (dt * A[None, None, :]).to(torch.float32)
    # fold heads: (b,t,h,p) -> (b*h, t, p)
    xf = xdt.movedim(2, 1).reshape(b * h, t, p).contiguous()
    dAf = dA.movedim(2, 1).reshape(b * h, t).contiguous()
    Bf = B.to(torch.float32).contiguous()
    Cf = C.to(torch.float32).contiguous()
    if use_kernel and x.is_cuda:
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (x, dt, A, B, C)):
            raise RuntimeError(
                "ssd_scan_fused: the ssd_scan kernel has no backward, and "
                "its inputs require a gradient; set use_ssd_kernel=False "
                "to train through the plain chunked scan")
        y, state = ssd_scan_kernel(xf, dAf, Bf, Cf, chunk=ck, heads=h)
    else:
        def per_head(a):
            return a[:, None].expand(b, h, t, n).reshape(b * h, t, n)
        y, state = ssd_scan_ref(xf, dAf, per_head(Bf), per_head(Cf),
                                chunk=ck)
    y = y.reshape(b, h, t, p).movedim(1, 2)
    return y, state.reshape(b, h, p, n)
