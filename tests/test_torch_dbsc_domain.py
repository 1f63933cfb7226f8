"""The domain the DBSC bit-slice kernel narrows to, held on the CPU.

The hand-written kernel (``csrc/bitslice_matmul.cu``) narrows its operands
to int8 for the tensor cores.  That is exact on the TPU kernel's contract
only: activation planes in [0, 63], weights in [-128, 127], row flags in
{0, 1}.  These tests push extreme activations (huge, negative and
all-zero rows) and weights at +-amax through ``ops.bitslice_matmul``'s own
quantizers, check that what reaches the integer matmul's call site lies in
that domain, and check that on those planes, and at the domain's corners
(where ``(hi @ w) << 6`` wraps past int32), the port's plain version
equals the JAX package's ``bitslice_matmul_ref``.  All integers: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitslice_matmul.ref import (
    bitslice_matmul_ref as j_bitslice_ref)
from repro_torch.kernels.bitslice_matmul import ops
from repro_torch.kernels.bitslice_matmul.ref import (
    bitslice_matmul_ref as t_bitslice_ref)

M, K, N = 24, 40, 12


def _activations(kind, rng):
    x = rng.standard_normal((M, K)).astype(np.float32)
    if kind == "extreme rows":
        x[0] = 3.0e38                    # the largest finite float32
        x[1, ::2] = -3.0e38
        x[2:5] = -np.abs(x[2:5]) - 1.0   # all negative
        x[5:7] = 0.0
    elif kind == "one huge value":
        x[3, 7] = 1.0e30                 # every other code rounds to 0
    elif kind == "all negative":
        x = -np.abs(x) - 1e-3
    elif kind == "all zero":
        x[:] = 0.0
    return x


def _weights(rng):
    w = rng.standard_normal((K, N)).astype(np.float32)
    amax = float(np.abs(w).max())
    w[0, 0], w[1, 1] = amax, -amax       # both ends of the symmetric grid
    w[2, :] = amax
    w[3, :] = -amax
    return w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["normal", "extreme rows", "one huge value",
                                  "all negative", "all zero"])
def test_quantizers_feed_the_kernel_its_domain(monkeypatch, kind, masked):
    rng = np.random.default_rng(11)
    x, w = _activations(kind, rng), _weights(rng)
    important = rng.random(M) < 0.5 if masked else None
    seen = []

    def capture(hi, lo, wq, prec):
        seen.append((hi, lo, wq, prec))
        return t_bitslice_ref(hi, lo, wq, prec)

    monkeypatch.setattr(ops, "bitslice_matmul_ref", capture)
    y = ops.bitslice_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            important=None if important is None
                            else torch.from_numpy(important))
    assert len(seen) == 1 and tuple(y.shape) == (M, N)
    hi, lo, wq, prec = seen[0]
    assert all(t.dtype == torch.int32 for t in (hi, lo, wq, prec))
    assert int(hi.min()) >= 0 and int(hi.max()) <= 63
    assert int(lo.min()) >= 0 and int(lo.max()) <= 63
    assert int(wq.min()) >= -128 and int(wq.max()) <= 127
    assert set(prec.unique().tolist()) <= {0, 1}
    if kind != "all zero":           # +-amax lands on the grid's ends
        assert int(wq[0, 0]) == 127 and int(wq[1, 1]) == -127
    if masked:                       # INT6 rows carry no low slice
        assert int(lo[prec[:, 0] == 0].abs().sum()) == 0
    if kind in ("extreme rows", "all negative"):
        assert int(hi[2:5].abs().sum() + lo[2:5].abs().sum()) == 0
    if kind == "extreme rows":       # the top INT12 code, 4095
        assert int(hi[0].min()) == 63
        assert int(lo[0].min()) == 63 * int(prec[0, 0])
    # the plain version on these planes equals the JAX package's
    acc_j = j_bitslice_ref(*(jnp.asarray(t.numpy()) for t in seen[0]))
    np.testing.assert_array_equal(np.asarray(acc_j),
                                  t_bitslice_ref(*seen[0]).numpy())


@pytest.mark.parametrize("k", [77, 5120])
@pytest.mark.parametrize("hi_v,lo_v,w_v", [(63, 63, -128), (63, 63, 127),
                                           (63, 0, -128), (0, 63, 127)])
def test_plain_matches_jax_at_the_domain_corners(k, hi_v, lo_v, w_v):
    hi = np.full((3, k), hi_v, np.int32)
    lo = np.full((3, k), lo_v, np.int32)
    w = np.full((k, 5), w_v, np.int32)
    w[:, 1] = -128 if w_v == 127 else 127     # the other end beside it
    prec = np.array([[1], [0], [1]], np.int32)
    acc_j = np.asarray(j_bitslice_ref(*(jnp.asarray(a)
                                        for a in (hi, lo, w, prec))))
    acc_t = t_bitslice_ref(*(torch.from_numpy(a)
                             for a in (hi, lo, w, prec)))
    np.testing.assert_array_equal(acc_j, acc_t.numpy())
    exact = (hi_v * 64 + lo_v) * w_v * k        # row 0: both slices
    assert int(acc_t[0, 0]) == (exact + 2 ** 31) % 2 ** 32 - 2 ** 31
