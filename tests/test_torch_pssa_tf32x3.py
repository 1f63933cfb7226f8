"""The PSSA kernel's 3xTF32 precision scheme, emulated on the CPU.

``csrc/pssa_attention.cu`` splits every f32 operand x into big = tf32(x)
and small = tf32(x - big), both rounded to nearest with ties away from zero
to TF32's 10 mantissa bits, and multiplies as small*big + big*small +
big*big.  This file carries its own emulation of that split (the same
integer rounding the kernel does) and holds the scheme to what the kernel's
counters need.  3xTF32 alone prunes like the plain fp32 version except on
keys that sit on the threshold (ties), so the kernel decides every key
within a guard band of the threshold in the plain version's own order; with
that band the counters are the plain version's.  The main path does not use
the emulation.  The 1xTF32 control shows that the checks can tell a scheme
that is too coarse.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pssa
from repro_torch.kernels.pssa_attention.ref import pssa_attention_stats_ref

THR = 1.0 / 8192.0
TIE_REL = 1e-5       # |p - tau| / tau at a flipped key: a tie (chip_smoke.py)
BAND_REL = 1e-4      # the kernel's guard band around the threshold


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> float32 rounded to 10 mantissa bits, to nearest, ties away
    from zero: the kernel's (bits + 0x1000) & 0xffffe000."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def scores(q: np.ndarray, k: np.ndarray, terms: int) -> torch.Tensor:
    """(q / sqrt(d)) k^T with the kernel's split: 3 terms (3xTF32, the small
    terms first) or 1 (big * big alone), float32 sums."""
    d = q.shape[-1]
    qb, qs = (torch.from_numpy(a) for a in split(q / np.float32(np.sqrt(d))))
    kb, ks = (torch.from_numpy(a) for a in split(k))
    big = torch.einsum("btd,bsd->bts", qb, kb)
    if terms == 1:
        return big
    return (torch.einsum("btd,bsd->bts", qs, kb)
            + torch.einsum("btd,bsd->bts", qb, ks)) + big


def inputs(bh: int, tq: int, tk: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, tq, d), dtype=np.float32)
    k, v = (rng.standard_normal((bh, tk, d), dtype=np.float32)
            for _ in range(2))
    return q, k, v


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


def test_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)             # TF32's ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp * 0.49,
                  one + ulp * 1.5], np.float32)
    assert tf32_rna(x).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                                    1 + 2 * 2.0 ** -10]


def keep_bits(q, k, terms, band_rel):
    """The kernel's decision procedure on emulated scores: p from the split
    scores decides every key, except that a key whose p lies within
    ``band_rel`` of the threshold takes the plain version's decision (the
    kernel recomputes it in the plain version's order).  Returns the keep
    bits, the plain ones, the plain p and the count of band keys."""
    d = q.shape[-1]
    p = torch.softmax(scores(q, k, terms), dim=-1)
    plain = torch.softmax(torch.einsum(
        "btd,bsd->bts", torch.from_numpy(q), torch.from_numpy(k))
        / np.sqrt(float(d)), dim=-1)
    band = (p - THR).abs() < band_rel * THR
    keep_p = plain >= THR
    return torch.where(band, keep_p, p >= THR), keep_p, plain, int(band.sum())


# The card tests' shapes (tests/test_torch_cuda.py), res 32, res 16 and the
# main path's T = 4096.
SHAPES = [(4, 256, 256, 40, 16), (2, 48, 48, 8, 16), (2, 128, 128, 160, 64),
          (2, 48, 48, 13, 16), (2, 1024, 1024, 80, 64), (4, 32, 256, 40, 16),
          (2, 128, 1024, 80, 64), (2, 100, 256, 40, 16),
          (4, 128, 1024, 40, 64), (16, 1024, 1024, 80, 32),
          (16, 256, 256, 160, 16), (2, 4096, 4096, 40, 64)]


@pytest.mark.parametrize("bh,tq,tk,d,patch", SHAPES)
def test_3xtf32_with_guard_band_counters_equal_plain(bh, tq, tk, d, patch):
    """Every key that 3xTF32 alone prunes differently from the plain version
    lies inside the kernel's guard band, so the counters are the plain
    version's, and the band holds few keys."""
    q, k, v = inputs(bh, tq, tk, d, tq + tk + d)
    keep, _, _, nband = keep_bits(q, k, 3, BAND_REL)
    _, nnz_p, xr_p = pssa_attention_stats_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), THR, patch)
    assert torch.equal(keep.sum(-1, dtype=torch.int32), nnz_p)
    assert torch.equal(
        pssa.patch_xor(keep, patch).sum(-1, dtype=torch.int32), xr_p)
    assert nband <= 1e-3 * keep.numel()


@pytest.mark.parametrize("bh,tq,tk,d,patch", SHAPES)
def test_3xtf32_alone_flips_only_ties(bh, tq, tk, d, patch):
    """Without the band, 3xTF32 flips keys only on the threshold: within
    the tie rule of chip_smoke.py."""
    q, k, _ = inputs(bh, tq, tk, d, tq + tk + d)
    p = torch.softmax(scores(q, k, 3), dim=-1)
    _, keep_p, plain, _ = keep_bits(q, k, 3, 0.0)
    flip = (p >= THR) != keep_p
    if bool(flip.any()):
        assert ((plain[flip] - THR).abs() / THR).max().item() <= TIE_REL


def test_1xtf32_control_fails_both():
    """Control: 1xTF32 flips keys far from the threshold, and the band does
    not cover them."""
    q, k, v = inputs(16, 1024, 1024, 80, 1024 + 1024 + 80)
    p = torch.softmax(scores(q, k, 1), dim=-1)
    keep, keep_p, plain, _ = keep_bits(q, k, 1, BAND_REL)
    flip = (p >= THR) != keep_p
    assert ((plain[flip] - THR).abs() / THR).max().item() > 10 * TIE_REL
    assert not torch.equal(keep, keep_p)
