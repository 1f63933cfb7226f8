"""Public op: PSSA attention over (B, H, T, d) with head folding.

A CUDA tensor goes through the hand-written kernel (which masks its own
ragged edges, so no padding is needed); a CPU tensor goes through the
plain PyTorch version.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.pssa_attention.kernel import (BLOCK_Q_CHOICES,
                                                       check_block_q,
                                                       pssa_attention_kernel)
from repro_torch.kernels.pssa_attention.ref import pssa_attention_stats_ref


def pssa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   threshold: float, patch: int, bq: int | None = None):
    """(B, H, Tq, d) q x (B, H, Tk, d) k/v -> (out (B, H, Tq, d),
    nnz (B, H, Tq), xor_ones (B, H, Tq)); ``patch`` must divide Tk.

    Tq may differ from Tk: temporal reuse gathers the queries to the
    active patch rows while the keys stay dense.  ``bq`` is the kernel's
    launch knob (``kernel.check_block_q``; ``None``: its launch rule); it
    moves no bit, and the plain version has none.
    """
    check_block_q(bq)
    b, h, t, d = q.shape
    tk = k.shape[2]
    if tk % patch:
        raise ValueError(f"pssa_attention: Tk={tk} is not a multiple of "
                         f"patch {patch}")
    qf = q.reshape(b * h, t, d).contiguous()
    kf, vf = (x.reshape(b * h, tk, d).contiguous() for x in (k, v))
    if q.is_cuda:
        out, nnz, xor_ones = pssa_attention_kernel(qf, kf, vf, threshold,
                                                   patch, bq=bq)
    else:
        out, nnz, xor_ones = pssa_attention_stats_ref(qf, kf, vf, threshold,
                                                      patch)
    return (out.reshape(b, h, t, d), nnz.reshape(b, h, t),
            xor_ones.reshape(b, h, t))


# ---------------------------------------------------------------------------
# Autotune hooks (repro_torch.kernels.autotune): geometry = (b, h, t, d, patch)
# ---------------------------------------------------------------------------
AUTOTUNE_KNOBS = ("attn_block_q",)
_PROBE_THRESHOLD = 1.0 / 8192.0       # the paper's PSSA operating point


def autotune_candidates(geom: tuple) -> tuple:
    """Every block the kernel takes, so the launch rule's own choice (32
    query rows where T <= 256, else 64) is always among them.

    ``attn_block_q``: query rows a block, 16 a warp.  The JAX package's
    ``attn_block_k`` has no counterpart: the 64-key tile is tied to the
    64-bit keep word per row and tile, to the patch-XOR carry and to pass
    1's per-tile float32 sum of the softmax normaliser, so another tile
    would move that sum's rounding and with it the exact counters.
    """
    return tuple({"attn_block_q": bq} for bq in BLOCK_Q_CHOICES)


def autotune_probe(geom: tuple, blocks: dict, *, device=None):
    """(fn, input sets) the autotuner times for one block config: q, k
    and v of the geometry from a seeded generator, as many sets as
    ``runtime.rotation`` asks."""
    b, h, t, d, patch = geom
    dev = runtime.resolve_device(device)
    n = runtime.rotation(3 * b * h * t * d * 4, dev)
    x = torch.randn((n, 3, b, h, t, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def fn(q, k, v):
        return pssa_attention(q, k, v, _PROBE_THRESHOLD, patch,
                              bq=blocks["attn_block_q"])
    return fn, [tuple(x[i].unbind(0)) for i in range(n)]
