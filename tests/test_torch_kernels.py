"""Port parity: the three kernel ops of ``repro_torch`` against the JAX
package's ops, with the Pallas kernels in interpret mode and through their
jnp references.

On the CPU the port's ops run their plain PyTorch versions (the CUDA
kernels run only on a card: ``tests/test_torch_cuda.py``).  Tolerances:
* PSSA ``nnz`` / patch-XOR counts, DBSC integer accumulators and TIPS
  importance masks: exact;
* attention outputs and CAS: rtol 1e-5, atol 1e-5 — float32 sums of up
  to 256 O(1) terms in a different order (blocked online softmax on the
  JAX side);
* the DBSC float output: rtol 1e-6, atol 1e-6 — equal integer
  accumulators, but XLA reassociates the two scale products inside
  ``jit`` (a couple of float32 ulps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as j_quant
from repro.kernels.bitslice_matmul.kernel import (
    bitslice_matmul_kernel as j_bitslice_kernel)
from repro.kernels.bitslice_matmul.ops import bitslice_matmul as j_bitslice
from repro.kernels.bitslice_matmul.ref import (
    bitslice_matmul_ref as j_bitslice_ref)
from repro.kernels.cross_attention_tips.ops import (
    cross_attention_cas as j_cross)
from repro.kernels.pssa_attention.ops import pssa_attention as j_pssa
from repro_torch.kernels.bitslice_matmul.kernel import (
    bitslice_matmul_kernel as t_bitslice_kernel)
from repro_torch.kernels.bitslice_matmul.ops import (
    bitslice_matmul as t_bitslice)
from repro_torch.kernels.bitslice_matmul.ref import (
    bitslice_matmul_ref as t_bitslice_ref)
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.kernels.cross_attention_tips.kernel import (
    cross_attention_tips_kernel as t_cross_kernel)
from repro_torch.kernels.cross_attention_tips.ops import (
    cross_attention_cas as t_cross)
from repro_torch.kernels.pssa_attention.kernel import (
    pssa_attention_kernel as t_pssa_kernel)
from repro_torch.kernels.pssa_attention.ops import pssa_attention as t_pssa

THR = 1.0 / 8192.0
RTOL, ATOL = 1e-5, 1e-5


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# PSSA attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,t,d,patch,bq,bk", [
    (1, 2, 48, 8, 16, 32, 32),     # keys padded 48 -> 64 (kv_len=48)
    (2, 4, 64, 16, 16, 128, 128),  # smoke res 8
    (1, 4, 256, 8, 16, 128, 128),  # smoke res 16
])
def test_pssa_attention_matches_jax(b, h, t, d, patch, bq, bk):
    rng = np.random.default_rng(t + d)
    q, k, v = (_normal(rng, (b, h, t, d), 2.0) for _ in range(3))
    out_t, nnz_t, xor_t = t_pssa(*(torch.from_numpy(x) for x in (q, k, v)),
                                 THR, patch=patch)
    for use_kernel in (True, False):
        out_j, nnz_j, xor_j = j_pssa(
            *(jnp.asarray(x) for x in (q, k, v)), THR, patch=patch,
            use_kernel=use_kernel, interpret=True, bq=bq, bk=bk)
        np.testing.assert_array_equal(np.asarray(nnz_j), nnz_t.numpy())
        np.testing.assert_array_equal(np.asarray(xor_j), xor_t.numpy())
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=RTOL, atol=ATOL)
    # the counters are live: some scores pruned, some patches differ
    assert 0 < int(nnz_t.sum()) < b * h * t * t
    assert int(xor_t.sum()) > 0


def test_pssa_attention_rejects_bad_patch():
    x = torch.zeros((1, 1, 48, 8))
    with pytest.raises(ValueError):
        t_pssa(x, x, x, THR, patch=32)


# ---------------------------------------------------------------------------
# Cross-attention TIPS
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,tq,tk,d,bq", [
    (1, 2, 48, 7, 8, 32),      # ragged queries, 7 keys padded to 8
    (2, 4, 256, 8, 8, 128),    # smoke res 16 under CFG
    (2, 4, 16, 8, 16, 128),    # smoke res 4
])
def test_cross_attention_cas_matches_jax(b, h, tq, tk, d, bq):
    rng = np.random.default_rng(tq + tk)
    q = _normal(rng, (b, h, tq, d), 2.0)
    k, v = (_normal(rng, (b, h, tk, d), 2.0) for _ in range(2))
    out_t, cas_t = t_cross(*(torch.from_numpy(x) for x in (q, k, v)))
    for use_kernel in (True, False):
        out_j, cas_j = j_cross(*(jnp.asarray(x) for x in (q, k, v)),
                               use_kernel=use_kernel, interpret=True, bq=bq)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(cas_t.numpy(), np.asarray(cas_j),
                                   rtol=RTOL, atol=ATOL)
        thr = float(np.median(np.asarray(cas_j).mean(1)))
        np.testing.assert_array_equal(
            np.asarray(cas_j).mean(1) < thr, cas_t.numpy().mean(1) < thr)


# ---------------------------------------------------------------------------
# DBSC bit-slice matmul
# ---------------------------------------------------------------------------
def _planes(rng, m, k, n):
    vals = rng.integers(0, 4096, (m, k)).astype(np.int32)
    hi, lo = (np.asarray(x) for x in j_quant.bitslice_split(
        jnp.asarray(vals)))
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    prec = rng.integers(0, 2, (m, 1)).astype(np.int32)
    return hi, lo, w, prec


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 77, 50)])
def test_bitslice_integers_match_jax_kernel(m, k, n):
    rng = np.random.default_rng(m)
    hi, lo, w, prec = _planes(rng, m, k, n)
    assert (prec == 0).any() and (prec == 1).any()
    acc_t = t_bitslice_ref(*(torch.tensor(x) for x in (hi, lo, w, prec)))
    acc_ref = j_bitslice_ref(*(jnp.asarray(x) for x in (hi, lo, w, prec)))
    np.testing.assert_array_equal(np.asarray(acc_ref), acc_t.numpy())
    if m % 128 == 0 and k % 128 == 0 and n % 128 == 0:
        for dataflow in ("weight_stationary", "input_stationary"):
            acc_k = j_bitslice_kernel(
                *(jnp.asarray(x) for x in (hi, lo, w, prec)),
                dataflow=dataflow, interpret=True)
            np.testing.assert_array_equal(np.asarray(acc_k), acc_t.numpy())


def test_bitslice_int32_wraparound_matches_jax():
    # 63 * 127 * 5120 << 6 passes 2**31: XLA wraps, the port must too
    hi = np.full((4, 5120), 63, np.int32)
    w = np.full((5120, 3), 127, np.int32)
    prec = np.array([[1], [0], [1], [1]], np.int32)
    acc_j = np.asarray(j_bitslice_ref(jnp.asarray(hi), jnp.asarray(hi),
                                      jnp.asarray(w), jnp.asarray(prec)))
    acc_t = t_bitslice_ref(torch.from_numpy(hi), torch.from_numpy(hi),
                           torch.from_numpy(w), torch.from_numpy(prec))
    np.testing.assert_array_equal(acc_j, acc_t.numpy())
    exact = 63 * 127 * 5120 * 65
    assert exact > 2 ** 31 and int(acc_t[0, 0]) == exact - 2 ** 32


@pytest.mark.parametrize("with_mask", [False, True])
def test_bitslice_matmul_float_path_matches_jax(with_mask):
    rng = np.random.default_rng(7)
    x = _normal(rng, (96, 40), 1.5)
    w = _normal(rng, (40, 72), 0.2)
    imp = rng.random(96) < 0.5 if with_mask else None
    y_t = t_bitslice(torch.from_numpy(x), torch.from_numpy(w),
                     important=None if imp is None
                     else torch.from_numpy(imp))
    for use_kernel in (True, False):
        y_j = j_bitslice(jnp.asarray(x), jnp.asarray(w),
                         important=None if imp is None else jnp.asarray(imp),
                         use_kernel=use_kernel, interpret=True)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   rtol=1e-6, atol=1e-6)


def test_bitslice_matmul_rejects_unknown_dataflow():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="dataflow"):
        t_bitslice(x, x, dataflow="output_stationary")


def test_kernel_policy_presets():
    assert TKP.reference() == TKP()
    assert TKP.fused() == TKP(self_attention="fused",
                              cross_attention="fused", ffn="reference",
                              bitmap="kernel", reuse="kernel")
    assert TKP.auto("cpu") == TKP.reference()
    with pytest.raises(ValueError, match="reuse"):
        TKP(reuse="fused")
    with pytest.raises(ValueError, match="ffn"):
        TKP(ffn="int8")


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors only, no CPU route
# ---------------------------------------------------------------------------
def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        t_pssa_kernel(x, x, x, THR, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_cross_kernel(x, x[:, :8], x[:, :8])
    i = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_bitslice_kernel(i, i, i, i[:, :1])
