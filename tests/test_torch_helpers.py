"""The port's public core helpers against the JAX package, on the CPU.

``core.pssa``: ``patch_unxor``, ``compress_decompress``, ``ema_reduction``;
``core.tips``: ``spot``, ``adaptive_threshold``, ``tips_schedule``;
``core.quant``: ``dequantize``, ``fake_quant_act``, ``fake_quant_weight``,
``bitslice_merge``, ``quantized_matmul_reference``.

The same numpy inputs (from a seed) go through both packages.  Tolerances:

* integers and masks (bitmaps, the important mask, its counts, the
  schedule, ``bitslice_merge``): equal;
* ``quantized_matmul_reference``: bit for bit.  Its integers are exact on
  both sides, and the port mirrors the jitted JAX rescale (XLA
  reassociates ``acc * (sx * sw)`` into ``acc * ((ax * aw) * c)``);
* the fake quantisers against jitted JAX (the port's scales are the
  jitted ``amax * (1 / qmax)``, ROADMAP Queue 3 item 2): bit for bit;
  ``dequantize`` and ``ema_reduction`` against eager JAX: bit for bit;
* ``spot``'s CAS: 1e-6 relative (a head mean of float32 values; bit for
  bit measured, both sum the heads in order); its ratio: equal, it comes
  from the equal mask;
* ``adaptive_threshold``: bit for bit (the port mirrors ``jnp.quantile``
  and the FMA XLA's CPU backend contracts its interpolation into), over
  the whole tensor and per row as ``precision.spot_cas`` takes it;
* the TIPS low-precision ratio ``1 - mean(important)`` at its three
  sites (``tips.spot``, ``precision.spot_cas`` and the cross-attention's
  ``stats_rows`` slice): bit for bit the jitted JAX engine's, which
  rounds ``1 - count * float32(1 / n)`` once (one FMA), at counts whose
  n is not a power of two (ROADMAP Queue 3 item 21, closed);
* ``precision.spot_cas``'s ratio over 5 x 1001 tokens against EAGER JAX:
  within 2**-23 absolute, one float32 ulp of the mean near 1 it is taken
  from.  Eager JAX rounds the product before the subtraction; at a
  power-of-two count the forms are the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pssa as jpssa
from repro.core import quant as jquant
from repro.core import tips as jtips
from repro_torch.core import pssa, quant, tips

CAS_RTOL = 1e-6
RATIO_ATOL = 2.0 ** -23     # one float32 ulp of a mean near 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-width tensors gain nothing from intra-op threads, and the
    suite's workers share the cores: one thread a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.reshape(-1).view(np.uint8),
                          want.reshape(-1).view(np.uint8))


def _sas(seed, shape=(2, 3, 64, 64), scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(x) * scale, axis=-1))


# ----------------------------------------------------------------------------
# core.pssa
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("patch", [4, 16, 32])
def test_patch_unxor_matches_jax_and_inverts_patch_xor(patch):
    bm = np.random.default_rng(patch).random((2, 3, 32, 64)) < 0.3
    xb = np.asarray(jpssa.patch_xor(jnp.asarray(bm), patch))
    got = pssa.patch_unxor(_t(xb), patch)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpssa.patch_unxor(xb, patch)))
    np.testing.assert_array_equal(got.numpy(), bm)
    assert torch.equal(pssa.patch_xor(got, patch), _t(xb))


@pytest.mark.parametrize("patch,threshold", [(8, pssa.DEFAULT_THRESHOLD),
                                             (32, pssa.DEFAULT_THRESHOLD),
                                             (16, 1e-2)])
def test_compress_decompress_is_lossless_and_matches_jax(patch, threshold):
    sas = _sas(1)
    got = pssa.compress_decompress(_t(sas), patch, threshold)
    _same_bits(got, jpssa.compress_decompress(jnp.asarray(sas), patch,
                                              threshold))
    assert torch.equal(got, pssa.prune(_t(sas), threshold))
    assert 0 < int((got != 0).sum()) < got.numel()


@pytest.mark.parametrize("patch,scale", [(8, 3.0), (32, 3.0), (32, 0.5)])
def test_ema_reduction_matches_jax(patch, scale):
    sas = _sas(2, scale=scale)
    got = pssa.ema_reduction(pssa.compress_stats(_t(sas), patch))
    want = jpssa.ema_reduction(jpssa.compress_stats(jnp.asarray(sas), patch))
    _same_bits(got, want)


# ----------------------------------------------------------------------------
# core.tips
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("shape,threshold,cls_index", [
    ((2, 8, 64, 77), 0.01, 0), ((2, 8, 64, 77), 0.05, 0),
    ((8, 256, 16), 0.06, 0), ((2, 4, 64, 16), 0.1, 3)])
def test_spot_matches_jax(shape, threshold, cls_index):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) * 2.0, axis=-1))
    got = tips.spot(_t(probs), threshold, cls_index)
    want = jtips.spot(jnp.asarray(probs), threshold, cls_index)
    np.testing.assert_array_equal(got.important.numpy(),
                                  np.asarray(want.important))
    assert got.important.shape == shape[:-3] + shape[-2:-1]
    np.testing.assert_allclose(got.cas.numpy(), np.asarray(want.cas),
                               rtol=CAS_RTOL, atol=0)
    _same_bits(got.low_precision_ratio, want.low_precision_ratio)
    assert 0 < int(got.important.sum()) < got.important.numel()


@pytest.mark.parametrize("n", [4096, 1001])
@pytest.mark.parametrize("target", [0.0, 0.3, 0.448, 0.56, 0.9, 1.0])
def test_adaptive_threshold_matches_jax(n, target):
    cas = (np.random.default_rng(n).random(n) * 0.1).astype(np.float32)
    got = tips.adaptive_threshold(_t(cas), target)
    want = jtips.adaptive_threshold(jnp.asarray(cas), target)
    _same_bits(got, want)
    # the mask it draws: exact counts
    assert int((_t(cas) < got).sum()) == int((cas < np.asarray(want)).sum())


@pytest.mark.parametrize("target", [0.0, 0.448, 0.9, 1.0])
def test_adaptive_threshold_per_row_matches_jax(target):
    """Along the token axis, as ``precision.spot_cas`` takes it: each
    row's threshold bit for bit ``jnp.quantile(axis=-1, keepdims=True)``
    (a row holding a NaN gives NaN), spot_cas's mask equal and its
    ratio within RATIO_ATOL."""
    from repro.core import precision as jprecision
    from repro_torch.core import precision
    cas = (np.random.default_rng(9).random((3, 2, 1001)) * 0.1).astype(
        np.float32)
    cas[1, 0, 17] = np.nan
    got = tips.adaptive_threshold(_t(cas), target, dim=-1)
    want = jnp.quantile(jnp.asarray(cas), 1.0 - target, axis=-1,
                        keepdims=True)
    assert got.shape == (3, 2, 1)
    _same_bits(got, want)
    assert bool(torch.isnan(got[1, 0, 0])) and int(torch.isnan(got).sum()) == 1
    ok = np.delete(cas.reshape(6, -1), 2, axis=0)
    got = precision.spot_cas(_t(ok), precision.PrecisionPolicy.adaptive(
        target))
    want = jprecision.spot_cas(jnp.asarray(ok),
                               jprecision.PrecisionPolicy.adaptive(target))
    np.testing.assert_array_equal(got.important.numpy(),
                                  np.asarray(want.important))
    np.testing.assert_allclose(got.low_precision_ratio.numpy(),
                               np.asarray(want.low_precision_ratio),
                               rtol=0, atol=RATIO_ATOL)


# the diffusion path's counts: 5 x 1001 tokens (ROADMAP Queue 3 item 21)
# and batch 3 at the UNet's 4096 / 1024 / 256 tokens a row
RATIO_CASES = [(5, 1001), (3, 4096), (3, 1024), (3, 256)]


def _masks(rows, tokens, n_counts=12):
    """Masks of (rows, tokens) whose counts cover the ends, thirds and
    halves of n and random counts between, each at random positions."""
    n = rows * tokens
    rng = np.random.default_rng(n)
    counts = sorted({0, 1, 2, n // 3, n // 2, n - 1, n,
                     *rng.integers(3, n - 1, n_counts).tolist()})
    for c in counts:
        m = np.zeros(n, bool)
        m[rng.permutation(n)[:c]] = True
        yield c, m.reshape(rows, tokens)


@pytest.mark.parametrize("rows,tokens", RATIO_CASES)
def test_low_precision_ratio_matches_jitted_jax(rows, tokens):
    """``tips.low_precision_ratio`` (one count, and a vector of them as
    the engine takes a mesh's steps at once) and
    ``tips.mask_low_precision_ratio``, bit for bit ``jax.jit`` of the JAX
    package's ``1 - jnp.mean(mask)``."""
    jratio = jax.jit(lambda m: 1.0 - jnp.mean(m.astype(jnp.float32)))
    n = rows * tokens
    counts, wants = [], []
    for c, m in _masks(rows, tokens):
        want = jratio(jnp.asarray(m))
        _same_bits(tips.low_precision_ratio(
            torch.tensor(c, dtype=torch.int64), n), want)
        _same_bits(tips.mask_low_precision_ratio(_t(m)), want)
        counts.append(c)
        wants.append(np.asarray(want))
    _same_bits(tips.low_precision_ratio(torch.tensor(counts), n),
               np.stack(wants))
    assert bool(torch.isnan(tips.low_precision_ratio(torch.tensor(0), 0)))


@pytest.mark.parametrize("rows,tokens", RATIO_CASES)
def test_ratio_sites_match_jitted_jax(rows, tokens):
    """The three sites that report the ratio, each against ``jax.jit`` of
    its JAX counterpart on the same mask: ``tips.spot`` (a CLS score
    column under the threshold exactly where the mask is set),
    ``precision.spot_cas`` and the cross-attention's spotting tail with
    ``stats_rows`` (one spare row past the accounted ones)."""
    from repro.core import attention as jattention
    from repro.core import precision as jprecision
    from repro_torch.core import attention, precision
    j_spot = jax.jit(lambda p: jtips.spot(p, 0.5).low_precision_ratio)
    j_cas = jax.jit(lambda c: jprecision.spot_cas(
        c, jprecision.PrecisionPolicy(threshold=0.5)).low_precision_ratio)
    j_tail = jax.jit(lambda c: jattention._spot_and_slice(
        c, jprecision.PrecisionPolicy(threshold=0.5),
        stats_rows=rows)[0].low_precision_ratio)
    pol = precision.PrecisionPolicy(threshold=0.5)
    for _, m in _masks(rows, tokens, n_counts=4):
        cas = np.where(m, 0.25, 0.75).astype(np.float32)
        probs = np.stack([cas, 1.0 - cas], axis=-1)[:, None]  # (r, 1, T, 2)
        spare = np.concatenate([cas, np.full((1, tokens), 0.25,
                                             np.float32)])
        _same_bits(tips.spot(_t(probs), 0.5).low_precision_ratio,
                   j_spot(jnp.asarray(probs)))
        _same_bits(precision.spot_cas(_t(cas), pol).low_precision_ratio,
                   j_cas(jnp.asarray(cas)))
        _same_bits(attention._spot_and_slice(
            _t(spare), pol, stats_rows=rows)[0].low_precision_ratio,
            j_tail(jnp.asarray(spare)))


@pytest.mark.parametrize("active", [20, 5])
def test_tips_schedule_matches_jax(active):
    for it in range(26):
        got = tips.tips_schedule(it, active)
        assert got.dtype == torch.bool
        assert bool(got) == bool(jtips.tips_schedule(jnp.asarray(it),
                                                     active))
    its = np.arange(26, dtype=np.int32)
    np.testing.assert_array_equal(
        tips.tips_schedule(_t(its), active).numpy(),
        np.asarray(jtips.tips_schedule(jnp.asarray(its), active)))


# ----------------------------------------------------------------------------
# core.quant
# ----------------------------------------------------------------------------
def _x(seed, shape=(4, 33, 48), scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [None, -1])
def test_dequantize_matches_jax(axis):
    x = _x(4)
    q = jax.jit(jquant.quantize_act, static_argnames=("bits", "axis"))(
        jnp.asarray(x), 12, axis)
    got = quant.dequantize(quant.QTensor(_t(q.values), _t(q.scale)))
    _same_bits(got, jquant.dequantize(q))
    # and the port's own quantizer gives the same codes and scale
    mine = quant.quantize_act(_t(x), 12, axis)
    assert torch.equal(mine.values, _t(q.values))
    _same_bits(mine.scale, q.scale)


@pytest.mark.parametrize("axis", [None, -1, (1, 2)])
@pytest.mark.parametrize("bits", [12, 6])
def test_fake_quant_act_matches_jitted_jax(bits, axis):
    x = _x(5)
    want = jax.jit(jquant.fake_quant_act, static_argnames=("bits", "axis"))(
        jnp.asarray(x), bits, axis)
    xt = _t(x).requires_grad_()
    got = quant.fake_quant_act(xt, bits, axis)
    _same_bits(got, want)
    got.sum().backward()                    # straight-through
    assert torch.equal(xt.grad, torch.ones_like(xt))


@pytest.mark.parametrize("axis", [None, 0, (1, 2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_weight_matches_jitted_jax(bits, axis):
    w = _x(6)
    want = jax.jit(jquant.fake_quant_weight,
                   static_argnames=("bits", "axis"))(jnp.asarray(w), bits,
                                                     axis)
    _same_bits(quant.fake_quant_weight(_t(w), bits, axis), want)


def test_fake_quant_of_an_all_negative_tensor_matches_jax():
    """``amax`` clamps at 1e-8: every code 0, the output 0."""
    x = -np.abs(_x(7))
    want = jax.jit(jquant.fake_quant_act)(jnp.asarray(x))
    got = quant.fake_quant_act(_t(x))
    _same_bits(got, want)
    assert not bool(got.any())


def test_bitslice_merge_matches_jax_and_inverts_the_split():
    r = np.random.default_rng(8)
    codes = r.integers(0, 4096, (17, 23)).astype(np.int32)
    hi, lo = quant.bitslice_split(_t(codes))
    got = quant.bitslice_merge(hi, lo)
    np.testing.assert_array_equal(got.numpy(), codes)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jquant.bitslice_merge(hi.numpy(),
                                                      lo.numpy())))
    h2 = r.integers(0, 64, (5, 7)).astype(np.int32)
    l2 = r.integers(0, 64, (5, 7)).astype(np.int32)
    got = quant.bitslice_merge(_t(h2), _t(l2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jquant.bitslice_merge(h2, l2)))


@pytest.mark.parametrize("bits", [12, 6])
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (64, 128, 64), (5, 300, 7)])
def test_quantized_matmul_reference_matches_jax(m, k, n, bits):
    r = np.random.default_rng(m * k + bits)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    want = jquant.quantized_matmul_reference(jnp.asarray(x), jnp.asarray(w),
                                             precision_bits=bits)
    _same_bits(quant.quantized_matmul_reference(_t(x), _t(w), bits), want)
