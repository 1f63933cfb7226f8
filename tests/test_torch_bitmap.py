"""Port parity: the PSXU patch-bitmap op (bitmap ``s >= tau``, patch XOR,
per-patch popcount, 32 keys packed per uint32 word) against the JAX
package's ``patch_bitmap`` with its Pallas kernel in interpret mode and
through its jnp reference.

On the CPU the port runs the plain PyTorch version (the CUDA kernel runs
only on a card: ``tests/test_torch_cuda.py``).  Inputs are made with
numpy from a seed.  Every comparison is exact: packed words, counts, and
the per-row sum of counts against the PSSA op's patch-XOR popcount.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.patch_bitmap.ops import patch_bitmap as j_bitmap
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.kernels.patch_bitmap.kernel import patch_bitmap_kernel
from repro_torch.kernels.patch_bitmap.ops import patch_bitmap as t_bitmap
from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref
from repro_torch.kernels.pssa_attention.ref import pssa_attention_stats_ref

THR = 1.0 / 8192.0


def _sas(rng, shape):
    """Softmax rows of random scores, about half of each row under THR."""
    s = rng.standard_normal(shape).astype(np.float32) * 3.0
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape,patch", [
    ((2, 70, 64), 16),          # rows not a multiple of the JAX block
    ((3, 16, 256), 16),
    ((2, 32, 128), 32),
    ((1, 64, 256), 64),
    ((2, 2, 8, 1024), 64),      # two leading axes
    ((5, 96), 32)])
def test_patch_bitmap_matches_jax(shape, patch):
    sas = _sas(np.random.default_rng(sum(shape) + patch), shape)
    packed_t, counts_t = t_bitmap(torch.from_numpy(sas), patch, THR)
    assert packed_t.dtype == torch.uint32 and counts_t.dtype == torch.int32
    for use_kernel in (True, False):
        packed_j, counts_j = j_bitmap(jnp.asarray(sas), patch, THR,
                                      use_kernel=use_kernel, interpret=True)
        np.testing.assert_array_equal(packed_t.numpy(),
                                      np.asarray(packed_j))
        np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    # live: words carry bits, and the XOR changed the per-patch counts
    raw = (sas >= THR).reshape(*shape[:-1], shape[-1] // patch, patch)
    assert (packed_t.numpy() != 0).any()
    assert (counts_t.numpy() != raw.sum(-1)).any()


@pytest.mark.parametrize("policy", [TKP(), TKP.fused()])
def test_dispatch_patch_bitmap_routes_to_the_same_bits(policy):
    sas = _sas(np.random.default_rng(3), (4, 32, 64))
    packed, counts = t_dispatch.patch_bitmap(policy, torch.from_numpy(sas),
                                             16, THR)
    packed_j, counts_j = j_bitmap(jnp.asarray(sas), 16, THR,
                                  use_kernel=False)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))


def test_threshold_is_inclusive_and_bits_are_lsb_first():
    sas = np.zeros((1, 64), np.float32)
    sas[0, [0, 5, 33]] = THR             # exactly at the threshold: kept
    sas[0, 40] = np.nextafter(np.float32(THR), np.float32(0))
    packed, counts = patch_bitmap_ref(torch.from_numpy(sas), 32, THR)
    assert packed.view(torch.int32).tolist() == [[(1 << 0) | (1 << 5),
                                                  (1 << 1) ^ (1 << 0)
                                                  ^ (1 << 5)]]
    assert counts.tolist() == [[2, 3]]
    packed_j, counts_j = j_bitmap(jnp.asarray(sas), 32, THR,
                                  use_kernel=False)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))


@pytest.mark.parametrize("t,d,patch", [(64, 8, 16), (128, 16, 32),
                                       (256, 8, 64)])
def test_counts_sum_to_the_pssa_xor_popcount(t, d, patch):
    rng = np.random.default_rng(t)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, d))
                                .astype(np.float32) * 2.0) for _ in range(3))
    _, nnz, xor_ones = pssa_attention_stats_ref(q, k, v, THR, patch)
    scores = torch.einsum("btd,bsd->bts", q, k) / float(np.sqrt(d))
    sas = torch.softmax(scores, dim=-1)
    packed, counts = t_bitmap(sas, patch, THR)
    assert torch.equal(counts.sum(-1, dtype=torch.int32), xor_ones)
    assert int(xor_ones.sum()) > 0 and bool((nnz > 0).all())


def test_patch_bitmap_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 32"):
        patch_bitmap_ref(torch.zeros((2, 48)), 16, THR)
    with pytest.raises(ValueError, match="CUDA"):
        patch_bitmap_kernel(torch.zeros((2, 64)), 16, THR)
