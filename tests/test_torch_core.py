"""Port parity: core numerics (quant, PSSA byte accounting, TIPS spotting,
energy ledger) of ``repro_torch`` against the JAX package.

The same numpy inputs go through both packages.  The JAX functions run
under ``jax.jit``, as everything on the model's path does (XLA compiles a
division of a scale by a constant into a multiply by its reciprocal, which
the port mirrors).  Tolerances:
* integer codes, PSSA counters, float32 ``PSSAStats``, importance masks
  and the ledger: exact (same integer arithmetic, same float32 byte
  arithmetic in the same order, same Python ledger);
* the adaptive-spotting quantile threshold: 1e-6 relative (both
  interpolate linearly, the arithmetic order may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as j_precision
from repro.core import pssa as j_pssa
from repro.core import quant as j_quant
from repro.core import tips as j_tips
from repro.diffusion import ledger as j_ledger
from repro.diffusion.unet import UNetConfig as JUNetConfig
from repro_torch.core import precision as t_precision
from repro_torch.core import pssa as t_pssa
from repro_torch.core import quant as t_quant
from repro_torch.core import tips as t_tips
from repro_torch.diffusion import ledger as t_ledger
from repro_torch.diffusion.unet import UNetConfig as TUNetConfig


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# quant
# ---------------------------------------------------------------------------
def test_quantize_act_exact_with_half_way_rounding():
    # amax 4095 -> scale exactly 1.0, so x.5 values sit exactly half way
    # and both packages must round them to even
    x = np.array([[4095.0, 0.5, 1.5, 2.5, 3.5, -3.0, 1000.49]],
                 np.float32)
    xj, xt = _both(x)
    qj, qt = jax.jit(j_quant.quantize_act)(xj), t_quant.quantize_act(xt)
    np.testing.assert_array_equal(np.asarray(qj.values), qt.values.numpy())
    assert qt.values.tolist() == [[4095, 0, 2, 2, 4, 0, 1000]]
    assert float(qj.scale) == float(qt.scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_bitslice_exact(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    w = (rng.standard_normal((48, 32)) * 0.1).astype(np.float32)
    xj, xt = _both(x)
    wj, wt = _both(w)
    qj, qt = jax.jit(j_quant.quantize_act)(xj), t_quant.quantize_act(xt)
    np.testing.assert_array_equal(np.asarray(qj.values), qt.values.numpy())
    assert np.float32(qj.scale) == qt.scale.numpy()
    wqj = jax.jit(j_quant.quantize_weight)(wj)
    wqt = t_quant.quantize_weight(wt)
    assert np.float32(wqj.scale) == wqt.scale.numpy()
    np.testing.assert_array_equal(np.asarray(wqj.values),
                                  wqt.values.numpy())
    for a, b in zip(j_quant.bitslice_split(qj.values),
                    t_quant.bitslice_split(qt.values)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    imp = rng.random(64) < 0.5
    mj = jax.jit(j_quant.mixed_precision_quantize)(xj, jnp.asarray(imp),
                                                   qj.scale)
    mt = t_quant.mixed_precision_quantize(xt, torch.from_numpy(imp),
                                          qt.scale)
    np.testing.assert_array_equal(np.asarray(mj.values), mt.values.numpy())


def test_apply_precision_mask_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    imp = rng.random((2, 16)) < 0.4
    for active in (True, False):
        yj = jax.jit(j_tips.apply_precision_mask)(
            jnp.asarray(x), jnp.asarray(imp), active)
        yt = t_tips.apply_precision_mask(torch.from_numpy(x),
                                         torch.from_numpy(imp), active)
        np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


# ---------------------------------------------------------------------------
# PSSA byte accounting
# ---------------------------------------------------------------------------
def _stats_equal(sj, st):
    for f in j_pssa.PSSAStats._fields:
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert a.dtype == b.dtype == np.float32, f
        assert a.tobytes() == b.tobytes(), (f, a, b)


@pytest.mark.parametrize("shape,patch", [((2, 4, 64, 64), 16),
                                         ((1, 2, 256, 256), 64)])
def test_compress_stats_bit_equal(shape, patch):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    sas = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sj, st = _both(sas.astype(np.float32))
    _stats_equal(j_pssa.compress_stats(sj, patch),
                 t_pssa.compress_stats(st, patch))
    _stats_equal(j_pssa.compress_stats_reference(sj, patch),
                 t_pssa.compress_stats_reference(st, patch))


@pytest.mark.parametrize("nnz,ones_xor,lead,t,patch", [
    (12345, 678, 32, 256, 16),
    # counters past float32's 2**24: the one float32 rounding must match
    (123456789, 23456789, 16, 4096, 64),
    (16777217, 3, 8, 4096, 64)])
def test_stats_from_counters_bit_equal(nnz, ones_xor, lead, t, patch):
    sj = j_pssa.stats_from_counters(jnp.asarray(nnz, jnp.int32),
                                    jnp.asarray(ones_xor, jnp.int32),
                                    lead=lead, tq=t, tk=t, patch=patch)
    st = t_pssa.stats_from_counters(torch.tensor(nnz), torch.tensor(ones_xor),
                                    lead=lead, tq=t, tk=t, patch=patch)
    _stats_equal(sj, st)


def test_exact_byte_counts_and_patch_xor_equal():
    assert (j_pssa.exact_byte_counts(5, 7, 2, 64, 64, 16)
            == t_pssa.exact_byte_counts(5, 7, 2, 64, 64, 16))
    bm = np.random.default_rng(5).random((3, 8, 64)) < 0.3
    np.testing.assert_array_equal(
        np.asarray(j_pssa.patch_xor(jnp.asarray(bm), 16)),
        t_pssa.patch_xor(torch.from_numpy(bm), 16).numpy())


# ---------------------------------------------------------------------------
# TIPS spotting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
def test_spot_cas_equal(policy):
    rng = np.random.default_rng(6)
    cas = (rng.random((2, 256)) * 0.1).astype(np.float32)
    pj = (j_precision.PrecisionPolicy.fixed(0.05) if policy == "fixed"
          else j_precision.PrecisionPolicy.adaptive(0.448))
    pt = (t_precision.PrecisionPolicy.fixed(0.05) if policy == "fixed"
          else t_precision.PrecisionPolicy.adaptive(0.448))
    rj = j_precision.spot_cas(jnp.asarray(cas), pj)
    rt = t_precision.spot_cas(torch.from_numpy(cas), pt)
    np.testing.assert_array_equal(np.asarray(rj.important),
                                  rt.important.numpy())
    assert (np.asarray(rj.low_precision_ratio).tobytes()
            == rt.low_precision_ratio.numpy().tobytes())
    if policy == "adaptive":
        thr_j = np.quantile(cas, 1 - 0.448, axis=-1)
        thr_t = torch.quantile(torch.from_numpy(cas), 1 - 0.448, dim=-1)
        np.testing.assert_allclose(thr_t.numpy(), thr_j, rtol=1e-6)


# ---------------------------------------------------------------------------
# Energy ledger copies
# ---------------------------------------------------------------------------
def test_generation_report_equal():
    ratios = {64: 0.41, 32: 0.52, 16: 0.77}
    per_iter = [dict(pssa=True, tips=i < 20, sas_ratio=ratios,
                     tips_low_ratio=0.3 + 0.01 * i, tips_mid=i % 2 == 0)
                for i in range(25)]
    rj = j_ledger.generation_report(
        JUNetConfig(), [j_ledger.LedgerOptions(**o) for o in per_iter])
    rt = t_ledger.generation_report(
        TUNetConfig(), [t_ledger.LedgerOptions(**o) for o in per_iter])
    assert rj.ema_bytes_total == rt.ema_bytes_total
    assert rj.ema_bytes_by_stage == rt.ema_bytes_by_stage
    assert rj.ema_energy_mj == rt.ema_energy_mj
    assert rj.compute_energy_mj == rt.compute_energy_mj
    assert rj.total_mj == rt.total_mj
