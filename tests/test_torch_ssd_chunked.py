"""The SSD scan kernel's chunk-parallel decomposition, emulated on the CPU.

``csrc/ssd_scan.cu`` computes the Mamba-2 SSD scan in phases over tiles of
min(T, 128) steps, the last one ragged, whatever the caller's chunk (the
chunked form is exact in any tiling): (A) each tile's own state
contribution S_c =
x^T (B o exp(dAc_last - dAc)) and decay exp(dAc_last), (B) the state pass
state_in[c] = decay[c-1] state_in[c-1] + S[c-1], (G) C B^T once per shared
B/C row, (C) y = ((C B^T) o L) x + exp(dAc) o (C state_in^T).  Every
product runs on the TF32 tensor cores in the 3xTF32 scheme: big = x
rounded to TF32 to nearest (ties away), small = x - big, which the tensor
core cuts to TF32 toward zero, and small*big + big*small + big*big.  dAc
is a warp scan in float64, and each exponent dAc_i - dAc_j is taken in
float64 before it is rounded to float32.
This file carries its own float32 emulation of those phases, with the
kernel's split and its cumsum order, and holds it against the JAX
package's kernel (Pallas interpret mode) and its sequential oracle on the
same numpy inputs.  Tolerance: |emulation - ref| <= 2e-4 (1 + |ref|), the
bound ``chip_smoke.py`` holds the kernel to on the card.  The 1xTF32
control shows that a single TF32 product would not meet it.  The main
path does not use the emulation; ``ref.py`` stays the sequential
recurrence.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel as jax_ssd_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref

TOL = 2e-4
LANES, PER_LANE = 32, 4          # the warp scan: 32 lanes of 4 steps
TILE = 128                       # the kernel's tile, or T when shorter


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 rounded to 10 mantissa bits, to nearest, ties away from
    zero: the kernel's (bits + 0x1000) & 0xffffe000."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_cut(x: np.ndarray) -> np.ndarray:
    """float32 cut to 10 mantissa bits toward zero: what the tensor core
    reads of a TF32 operand."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    """The kernel's split as the tensor core reads it: big = x rounded to
    TF32, small = x - big cut to TF32."""
    big = tf32_rna(x)
    return big, tf32_cut(x - big)


def mm(a: np.ndarray, b: np.ndarray, terms: int) -> np.ndarray:
    """a @ b (stacked) with the kernel's split: 3 terms (the small terms
    first, then big * big) or 1 (big * big alone); float32 sums."""
    ab, as_ = split(a)
    bb, bs = split(b)
    big = np.matmul(ab, bb)
    if terms == 1:
        return big
    return (np.matmul(as_, bb) + np.matmul(ab, bs)) + big


def warp_cumsum(da: np.ndarray) -> np.ndarray:
    """cumsum over the last axis (<= 128 steps) in float64, in the kernel's
    order: each lane sums its 4 steps in order, a Kogge-Stone scan of the
    lanes' sums, then each lane's exclusive prefix plus its own sums."""
    l = da.shape[-1]
    v = np.zeros(da.shape[:-1] + (LANES * PER_LANE,), np.float64)
    v[..., :l] = da
    v = v.reshape(da.shape[:-1] + (LANES, PER_LANE))
    for k in range(1, PER_LANE):
        v[..., k] = v[..., k] + v[..., k - 1]
    tot = v[..., PER_LANE - 1].copy()
    off = 1
    while off < LANES:
        up = np.zeros_like(tot)
        up[..., off:] = tot[..., :-off]
        tot = tot + up
        off *= 2
    ex = np.zeros_like(tot)
    ex[..., 1:] = tot[..., :-1]
    out = (ex[..., None] + v).reshape(da.shape[:-1] + (LANES * PER_LANE,))
    return out[..., :l]


def emulate(x, dA, B, C, heads: int, terms: int = 3):
    """The kernel's phases in float32 on numpy arrays: x (BH, T, p),
    dA (BH, T), B/C (BH / heads, T, n) -> (y (BH, T, p), state (BH, p, n)).
    Tiles of min(T, 128) steps; the last one is zero-padded, as the kernel
    pads it in shared memory (dA 0 past T keeps dAc constant, as the warp
    scan does, and zero x and B rows add nothing)."""
    bh, t, p = x.shape
    n = B.shape[-1]
    l = min(t, TILE)
    nc = -(-t // l)

    def tiles(a):
        pad = np.zeros(a.shape[:1] + (nc * l - t,) + a.shape[2:], a.dtype)
        return np.concatenate([a, pad], axis=1).reshape(
            a.shape[:1] + (nc, l) + a.shape[2:])
    xc = tiles(x)
    Bc, Cc = (tiles(np.repeat(a, heads, axis=0)) for a in (B, C))
    dac = warp_cumsum(tiles(dA))                            # float64
    last = dac[..., -1:]
    # phase A: S_c (bh, nc, p, n) and the tiles' decays
    w = np.exp((last - dac).astype(np.float32))
    S = mm(np.swapaxes(xc, -1, -2), Bc * w[..., None], terms)
    dec = np.exp(last[..., 0].astype(np.float32))
    # phase B: the state entering each tile, and the final state
    state_in = np.zeros_like(S)
    run = np.zeros((bh, p, n), np.float32)
    for c in range(nc):
        state_in[:, c] = run
        run = dec[:, c, None, None] * run + S[:, c]
    # phase G: C B^T; phase C: y, L a select
    i = np.arange(l)
    causal = i[:, None] >= i[None, :]
    seg = np.where(causal, dac[..., :, None] - dac[..., None, :], 0.0)
    L = np.where(causal, np.exp(seg.astype(np.float32)), np.float32(0))
    G = mm(Cc, np.swapaxes(Bc, -1, -2), terms)
    edac = np.exp(dac.astype(np.float32))
    y = (mm(Cc, np.swapaxes(state_in, -1, -2), terms) * edac[..., None]
         + mm(G * L, xc, terms))
    return y.reshape(bh, nc * l, p)[:, :t].astype(np.float32), run


def inputs(bh, t, p, n, heads, dt_scale, seed):
    """x ~ N(0, 1), dA = -softplus(N(0, 1)) * dt_scale, B, C ~ 0.3 N(0, 1)
    per batch row (read by ``heads`` rows each), as the card tests draw."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bh, t, p)).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((bh, t)), 0.0).astype(np.float32)
    B = (0.3 * r.standard_normal((bh // heads, t, n))).astype(np.float32)
    C = (0.3 * r.standard_normal((bh // heads, t, n))).astype(np.float32)
    return x, (-dt * dt_scale).astype(np.float32), B, C


def excess(a, ref) -> float:
    """max |a - ref| / (1 + |ref|)."""
    a, ref = (np.asarray(v, np.float64) for v in (a, ref))
    return float((np.abs(a - ref) / (1.0 + np.abs(ref))).max())


# (bh, t, p, n, chunk, heads, dt_scale): the card tests' six shapes (the
# smoke model, chunks that are not multiples of 32, chunk 1, chunk 256), a
# serve-like multi-chunk row (one batch row of 4 heads at the served
# widths), the large dt whose |dA| sums past 88 in a chunk, and two T
# ragged against the 128-step tile (chunk 100, and an odd T with chunk 1)
CASES = [(16, 128, 16, 8, 32, 8, 1.0), (16, 128, 16, 8, 128, 8, 1.0),
         (4, 256, 64, 128, 128, 2, 1.0), (6, 100, 16, 16, 100, 1, 1.0),
         (4, 97, 16, 8, 1, 2, 1.0), (2, 256, 32, 16, 256, 1, 1.0),
         (4, 1024, 64, 128, 128, 4, 1.0), (4, 256, 64, 128, 128, 1, 12.0),
         (4, 300, 16, 8, 100, 2, 1.0), (2, 333, 16, 8, 1, 1, 1.0)]
SERVE_LIKE = CASES[6]


def _case(case, terms=3):
    bh, t, p, n, chunk, heads, dts = case
    ins = inputs(bh, t, p, n, heads, dts, seed=t + p)
    if dts > 1:
        assert float(-ins[1][0, :chunk].sum()) > 88.0
    return ins, emulate(*ins, heads=heads, terms=terms)


def _folded(ins, heads):
    x, dA, B, C = ins
    return [jnp.asarray(a) for a in (x, dA, np.repeat(B, heads, axis=0),
                                      np.repeat(C, heads, axis=0))]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax_kernel_interpret(case):
    ins, (y, s) = _case(case)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    yj, sj = jax_ssd_kernel(*_folded(ins, case[5]), chunk=case[4],
                            interpret=True)
    assert excess(y, yj) <= TOL and excess(s, sj) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax_ref(case):
    ins, (y, s) = _case(case)
    yj, sj = jax_ssd_ref(*_folded(ins, case[5]))
    assert excess(y, yj) <= TOL and excess(s, sj) <= TOL


@pytest.mark.parametrize("case", [SERVE_LIKE, CASES[2]])
def test_one_tf32_term_fails_the_bound(case):
    """The control: with big * big alone (1xTF32, 2^-11 an operand) the
    same emulation lands past the bound, so the kernel takes 3xTF32."""
    ins, (y1, s1) = _case(case, terms=1)
    yj, sj = jax_ssd_ref(*_folded(ins, case[5]))
    worst = max(excess(y1, yj), excess(s1, sj))
    print(f"1xTF32 on {case}: {worst:.3e} of (1 + |ref|), bound {TOL}")
    assert worst > TOL


@pytest.mark.parametrize("l,scale,seed", [(128, 1.0, 0), (100, 1.0, 1),
                                          (1, 1.0, 2), (128, 12.0, 3)])
def test_warp_cumsum_is_a_cumsum(l, scale, seed):
    """The kernel's scan order agrees with a sequential float64 cumsum to
    float64 rounding (its last element, the tile's decay exponent,
    included)."""
    r = np.random.default_rng(seed)
    da = (-scale * np.logaddexp(r.standard_normal((64, l)), 0.0)
          ).astype(np.float32)
    got = warp_cumsum(da)
    want = np.cumsum(da.astype(np.float64), axis=-1)
    assert got.dtype == np.float64 and got.shape == da.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)


def test_float64_exponents_keep_the_large_dt_decay():
    """At large dt dAc reaches ~1e3 in a tile; the kernel takes dAc_i -
    dAc_j in float64, so every causal exponent is within an ulp of the
    exact segment sum, where a float32 cumsum's difference is off by more
    than 1e-4."""
    r = np.random.default_rng(4)
    da = (-12.0 * np.logaddexp(r.standard_normal((16, 128)), 0.0)
          ).astype(np.float32)
    exact = np.cumsum(da.astype(np.float64), axis=-1)
    seg = exact[:, :, None] - exact[:, None, :]
    dac = warp_cumsum(da)
    ours = (dac[:, :, None] - dac[:, None, :]).astype(np.float32)
    f32 = np.cumsum(da, axis=-1, dtype=np.float32)
    theirs = f32[:, :, None] - f32[:, None, :]
    causal = np.tril(np.ones((128, 128), bool))
    ulp = np.spacing(np.abs(seg).astype(np.float32))[:, causal]
    assert (np.abs(ours - seg)[:, causal] <= ulp).all()
    assert np.abs(theirs - seg)[:, causal].max() > 1e-4


def test_split_reconstructs_to_2_to_the_minus_21_without_bias():
    r = np.random.default_rng(0)
    x = (r.standard_normal(4096) * np.exp(r.uniform(-20, 20, 4096))
         ).astype(np.float32)
    big, small = split(x)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    diff = big.astype(np.float64) + small - x.astype(np.float64)
    assert (np.abs(diff) <= np.abs(x.astype(np.float64)) * 2.0 ** -21).all()
    # small's sign is either way, so the cut leaves no bias toward zero
    rel = diff / np.abs(x.astype(np.float64))
    assert abs(rel.mean()) < 2.0 ** -21 / 20


@pytest.mark.parametrize("t", [1, 127, 129, 255, 4095])
def test_any_t_runs_as_128_step_tiles(t):
    """T on either side of a tile boundary, and the odd 4095 whose chunk is
    1: the ragged last tile agrees with the oracle as a full one does."""
    ins = inputs(2, t, 16, 8, 1, 1.0, seed=t)
    y, s = emulate(*ins, heads=1)
    assert y.shape == (2, t, 16) and s.shape == (2, 16, 8)
    yj, sj = jax_ssd_ref(*_folded(ins, 1))
    assert excess(y, yj) <= TOL and excess(s, sj) <= TOL
