"""Public op: PSSA attention over (B, H, T, d) with head folding.

A CUDA tensor goes through the hand-written kernel (which masks its own
ragged edges, so no padding is needed); a CPU tensor goes through the
plain PyTorch version.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pssa_attention.kernel import pssa_attention_kernel
from repro_torch.kernels.pssa_attention.ref import pssa_attention_stats_ref


def pssa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   threshold: float, patch: int):
    """(B, H, Tq, d) q x (B, H, Tk, d) k/v -> (out (B, H, Tq, d),
    nnz (B, H, Tq), xor_ones (B, H, Tq)); ``patch`` must divide Tk.

    Tq may differ from Tk: temporal reuse gathers the queries to the
    active patch rows while the keys stay dense.
    """
    b, h, t, d = q.shape
    tk = k.shape[2]
    if tk % patch:
        raise ValueError(f"pssa_attention: Tk={tk} is not a multiple of "
                         f"patch {patch}")
    qf = q.reshape(b * h, t, d).contiguous()
    kf, vf = (x.reshape(b * h, tk, d).contiguous() for x in (k, v))
    if q.is_cuda:
        out, nnz, xor_ones = pssa_attention_kernel(qf, kf, vf, threshold,
                                                   patch)
    else:
        out, nnz, xor_ones = pssa_attention_stats_ref(qf, kf, vf, threshold,
                                                      patch)
    return (out.reshape(b, h, t, d), nnz.reshape(b, h, t),
            xor_ones.reshape(b, h, t))
