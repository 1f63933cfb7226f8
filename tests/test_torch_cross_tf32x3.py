"""The cross-attention kernel's 3xTF32 arithmetic, emulated on the CPU.

``csrc/cross_attention_tips.cu`` runs both products on the TF32 tensor
cores: every f32 operand x is split into big = tf32(x) and small =
tf32(x - big), both rounded to nearest with ties away from zero to TF32's
10 mantissa bits, and a product is small*big + big*small + big*big.  The
tensor core adds into its f32 accumulator by truncation, so each k-step of
8 sums its three products from zero there, and the step's sum, with half an
ulp of it added away from zero, is added on the CUDA cores, rounded to
nearest.  This file carries its own emulation of the split and of that
summation (a truncating accumulator over exact products) and holds the
kernel's arithmetic, at the main path's three
shapes with the CLS key scaled as ``chip_smoke.py`` scales it, to the
smoke's tolerances against the plain version: the CAS to 1e-5 absolute,
``out`` to 1e-3, and the importance masks under fixed and adaptive spotting
equal.  The 1xTF32 control (big*big alone) misses the CAS bound, which shows
that the check can tell a scheme that is too coarse.  The main path does not
use the emulation.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.core.precision import PrecisionPolicy, spot_cas
from repro_torch.kernels.cross_attention_tips.ref import (
    cross_attention_tips_ref)

OUT_ATOL = 1e-3        # chip_smoke.py: attention outputs
CAS_ATOL = 1e-5        # chip_smoke.py: CAS
CLS_KEY_SCALE = 2.5    # chip_smoke.py: the head-averaged CAS crosses 0.05
HEADS = 8              # BK-SDM-Tiny's heads: 16 (batch * head) rows = 2 rows
NEG_INF = -1e30
# (BH, Tq, Tk, d) at res 64, 32 and 16 under CFG
SHAPES = [(16, 4096, 77, 40), (16, 1024, 77, 80), (16, 256, 77, 160)]


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> float32 rounded to 10 mantissa bits, to nearest, ties away
    from zero: the kernel's (bits + 0x1000) & 0xffffe000."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def half_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half an ulp of float32 x with x's sign, 0 for 0 and subnormals: the
    kernel's (bits & 0xff800000) * 2^-24."""
    return (x.view(torch.int32) & -0x800000).view(torch.float32) * 2.0 ** -24


def mma_steps(a: torch.Tensor, b: torch.Tensor, terms: int,
              slices: int = 1) -> torch.Tensor:
    """(BH, M, K) @ (BH, K, N), K a multiple of 8, as the kernel sums it:
    each k-step of 8 adds its products (3: small*big, big*small, big*big;
    1: big*big) one after the other into an accumulator from zero,
    truncated to f32 after each, and the step's sum plus half an ulp of it
    away from zero is added to a partial sum in f32.  K falls into
    ``slices`` equal runs of k-steps (the warps that split d), whose
    partial sums are added in order."""
    ab, as_ = (torch.from_numpy(x) for x in split(a.numpy()))
    bb, bs = (torch.from_numpy(x) for x in split(b.numpy()))
    pairs = [(ab, bb)] if terms == 1 else [(as_, bb), (ab, bs), (ab, bb)]
    steps = a.shape[2] // 8
    res = None
    for sl in range(slices):
        part = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
        for st in range(sl * steps // slices, (sl + 1) * steps // slices):
            k0 = 8 * st
            acc = torch.zeros(part.shape, dtype=torch.float64)
            for x, y in pairs:
                acc = trunc_f32(acc + torch.bmm(x[..., k0:k0 + 8].double(),
                                                y[:, k0:k0 + 8].double())
                                ).double()
            step = acc.to(torch.float32)
            part = part + (step + half_ulp(step))
        res = part if res is None else res + part
    return res


def kernel_emulation(q, k, v, cls_index: int, terms: int):
    """The kernel's function on (BH, Tq, d) / (BH, Tk, d) float32 tensors:
    keys zero-padded to a multiple of 8 and masked, d zero-padded to a
    multiple of 8, from 12 k-steps on QK^T over 4 slices of d, scores times
    the float32 reciprocal of sqrt(d) after the dot, one softmax pass (row
    max, expf, sum, times the reciprocal of the sum), out = P V; (out,
    cas)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    tkp, dp = -(-tk // 8) * 8, -(-d // 8) * 8
    qp = torch.zeros(bh, tq, dp)
    kp, vp = torch.zeros(bh, tkp, dp), torch.zeros(bh, tkp, dp)
    qp[..., :d], kp[:, :tk, :d], vp[:, :tk, :d] = q, k, v
    s = mma_steps(qp, kp.transpose(1, 2).contiguous(), terms,
                  slices=4 if dp // 8 >= 12 else 1)
    s = s * (np.float32(1) / np.float32(math.sqrt(d)))
    s[..., tk:] = NEG_INF
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1 / e.sum(-1, keepdim=True))
    out = mma_steps(p, vp, terms)
    return out[..., :d], p[..., cls_index]


def inputs(bh, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, tq, d), dtype=np.float32)
    k, v = (rng.standard_normal((bh, tk, d), dtype=np.float32)
            for _ in range(2))
    k[:, 0] *= CLS_KEY_SCALE
    return tuple(torch.from_numpy(x) for x in (q, k, v))


@functools.lru_cache(maxsize=None)
def run(shape, terms):
    """(inputs, emulated (out, cas), plain (out, cas)) at ``shape``."""
    qkv = inputs(*shape, seed=sum(shape))
    return qkv, kernel_emulation(*qkv, 0, terms), \
        cross_attention_tips_ref(*qkv, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_and_big_is_tf32(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    big, small = split(x)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(big.astype(np.float64) + small - x.astype(np.float64))
    assert (err <= np.abs(x.astype(np.float64)) * 2.0 ** -21).all()


def test_truncating_accumulator_rounds_toward_zero():
    one = 1.0 + 2.0 ** -23                      # the float32 after 1
    x = torch.tensor([one - 2.0 ** -25, -(one - 2.0 ** -25), 3.0, -0.0],
                     dtype=torch.float64)
    assert trunc_f32(x).tolist() == [1.0, -1.0, 3.0, -0.0]


def test_half_ulp():
    x = torch.tensor([1.0, -3.0, 0.0, 1e-40, 2.0 ** 100], dtype=torch.float32)
    assert half_ulp(x).tolist() == [2.0 ** -24, -(2.0 ** -23), 0.0, 0.0,
                                    2.0 ** 76]


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_within_the_smoke_tolerances(shape):
    _, (out, cas), (out_p, cas_p) = run(shape, 3)
    assert (cas - cas_p).abs().max().item() <= CAS_ATOL
    assert (out - out_p).abs().max().item() <= OUT_ATOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("policy", [PrecisionPolicy.fixed(),
                                    PrecisionPolicy.adaptive()],
                         ids=["fixed", "adaptive"])
def test_3xtf32_importance_masks_equal_plain(shape, policy):
    bh, tq = shape[:2]
    _, (_, cas), (_, cas_p) = run(shape, 3)
    imp, imp_p = (spot_cas(c.reshape(bh // HEADS, HEADS, tq).mean(1),
                           policy).important for c in (cas, cas_p))
    assert 0.0 < imp_p.float().mean().item() < 1.0   # the cut splits rows
    assert torch.equal(imp, imp_p)


@pytest.mark.parametrize("shape", SHAPES)
def test_per_step_sums_leave_out_unbiased(shape):
    """The truncating accumulator, summed per k-step, pulls no output
    toward zero: the mean signed error of out against a float64 version,
    relative to |out|, is as small as the plain float32 version's."""
    (q, k, v), (out, _), (out_p, _) = run(shape, 3)
    d = q.shape[-1]
    p = torch.softmax(torch.einsum("btd,bsd->bts", q.double(), k.double())
                      / math.sqrt(d), -1)
    exact = torch.einsum("bts,bsd->btd", p, v.double())

    def bias(x):
        return ((x.double() - exact) / (exact.abs() + 1e-3)).mean().item()
    assert abs(bias(out)) <= max(1e-7, 10 * abs(bias(out_p)))


def test_1xtf32_control_misses_the_cas_bound():
    for shape in SHAPES:
        _, (_, cas), (_, cas_p) = run(shape, 1)
        assert (cas - cas_p).abs().max().item() > 10 * CAS_ATOL


def test_emulation_masks_padded_keys_and_columns():
    """Tk and d off the multiples of 8 and cls_index off 0: the padding is
    exact, so the emulation agrees with the plain version there too."""
    q, k, v = inputs(2, 40, 13, 12, seed=7)
    for cls_index in (0, 5, 12):
        out, cas = kernel_emulation(q, k, v, cls_index, 3)
        out_p, cas_p = cross_attention_tips_ref(q, k, v, cls_index)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(cas, cas_p, rtol=0, atol=1e-6)
