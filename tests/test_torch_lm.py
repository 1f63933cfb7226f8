"""The port's dense, moe and hybrid LM families against the JAX package,
on the CPU, at smoke widths.

Same numpy inputs, and JAX-initialised weights through
``convert_lm_params``, go through both packages.  ``repro.models``
imports the deprecated ``jax.experimental.shard_map``, which
``pyproject.toml`` turns into an error, so the JAX LM modules are imported
inside a fixture under a filter for that one message (as
``tests/test_torch_ssm.py`` does).  The JAX side runs under ``jax.jit``:
eager JAX rounds some scales differently (the TIPS quantiser's
``amax / 4095`` and the int8 KV store's ``x / 0.05`` become products by
the inverse inside ``jit``, and the port mirrors the jitted value).

Tolerances (each with its reason):

* float32, every module and every architecture's forward / prefill /
  decode_step with PSSA and TIPS off: 1e-5 of the largest value (only
  float32 sum order differs; ~1e-6 measured);
* the same with PSSA and TIPS on: 1e-3 (``FEATURES_RTOL``).  A float32
  INT12 code within an ulp of a rounding boundary (a few per layer at
  smoke widths) flips on sum order, moving one FFN input by a step, or
  by 64 steps on an INT6 row; a probability within an ulp of the PSSA
  threshold drops on one side only.  5.5e-5 measured;
* the int8 KV store and load, the MoE capacity, dispatch positions and
  drops, and every cache's shape and dtype: equal;
* bfloat16 modules against jitted JAX: 2 bf16 ulps of the largest value
  (``BF16_ULP``), on at most 2 % of the values (sum order and XLA's
  excess precision inside a fusion move a value across a rounding
  boundary now and then); the TIPS fake-quant itself bit for bit;
* bfloat16 models: 2e-2 of the largest logit (the bound of
  ``tests/test_torch_ssm.py``; bf16 roundings compound over the layers,
  and a TIPS code on a rounding boundary can move by one INT6 step);
* the MoE combine at top-4 in bfloat16: 2 bf16 ulps of the largest
  value, on any share of the values (XLA's scatter adds the four
  contributions in bfloat16, rounding after each add, in an order of
  its own; the port adds them in rank order, rounding after each add;
  k = 2 is exact in any order, 0 + a being exact);
* hybrid serving (float32, features off) against JAX ``forward`` on the
  prompt plus the decoded tokens: 1e-4 of the largest logit.  Both sides
  run the SSD scan in float32 (the port's decode recurrence against the
  JAX kernel in interpret mode, whose own bound against its oracle is
  2e-4 of each value); a zeroed KV cache or SSM state lands past it.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.convert import convert_lm_params
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

BF16_ULP = 2.0 ** -8
F32_RTOL = 1e-5
FEATURES_RTOL = 1e-3
MODEL_BF16_RTOL = 2e-2
HYBRID_SERVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def J():
    """The JAX package's LM modules (imported here, see the docstring)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.models import layers as jax_layers
    from repro.models import moe as jax_moe
    from repro.models import transformer as jax_t
    return types.SimpleNamespace(get_arch=jax_get_arch, L=jax_layers,
                                 moe=jax_moe, T=jax_t)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, ref) -> float:
    a, ref = _np(a), _np(ref)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-30))


def _assert_bf16_close(a, ref, share=0.02):
    """Within 2 bf16 ulps of the largest value, on at most ``share`` of
    the values (``None``: on any share)."""
    a, ref = _np(a), _np(ref)
    d = np.abs(a - ref)
    assert d.max() <= 2 * BF16_ULP * np.abs(ref).max(), d.max()
    if share is not None:
        assert np.mean(d > 0) <= share, np.mean(d > 0)


def _close(a, ref, dtype):
    if dtype == "float32":
        assert _rel(a, ref) < F32_RTOL
    else:
        _assert_bf16_close(a, ref)


def _jt(a, dtype):
    """numpy -> (JAX array, torch tensor), both in ``dtype``."""
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype)))


def _configs(J, arch, dtype, **kw):
    jc = J.get_arch(arch).smoke().scaled(dtype=dtype, **kw)
    pc = get_arch(arch).smoke().scaled(dtype=dtype, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    return jc, pc


def _params(J, jc, seed=0):
    jp = J.T.init_params(jax.random.PRNGKey(seed), jc)
    return jp, convert_lm_params(jax.device_get(jp))


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            T._layer(tp["layers"], 0))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_trees_close(tt, tj, rtol=F32_RTOL):
    lt, lj = _leaves(tt), _leaves(tj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        assert _rel(a, b) < rtol


# ----------------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_apply_rope_matches_jax(J, rotary_pct, dtype):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = (np.arange(8)[None] + np.array([[3], [40]])).astype(np.int32)
    xj, xt = _jt(x, dtype)
    yj = jax.jit(J.L.apply_rope, static_argnums=(2, 3))(
        xj, jnp.asarray(pos), rotary_pct, 500000.0)
    yt = L.apply_rope(xt, torch.from_numpy(pos), rotary_pct, 500000.0)
    assert yt.dtype == xt.dtype
    _close(yt, yj, dtype)
    rot = 16 if rotary_pct == 1.0 else 8
    np.testing.assert_array_equal(_np(yt)[..., rot:], _np(xt)[..., rot:])


# (window, global_flag, q_chunk, prune threshold): causal, the chunked
# query loop (T = 32, chunks of 8), pruned, the hybrid band with the
# global flag on and off, the plain band
GQA_CASES = [(0, None, 1024, 0.0), (0, None, 8, 0.0), (0, None, 8, 0.05),
             (8, True, 1024, 0.0), (8, False, 1024, 0.0),
             (8, False, 16, 0.02), (8, None, 1024, 0.0)]


@pytest.mark.parametrize("window,flag,q_chunk,prune", GQA_CASES)
def test_gqa_attention_matches_jax(J, window, flag, q_chunk, prune):
    jc, pc = _configs(J, "llama3-8b", "float32")
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)

    def run(x, pos):
        return J.L.gqa_attention(x, pj, jc, None, pos, window=window,
                                 prune_threshold=prune, q_chunk=q_chunk,
                                 global_flag=flag)
    out_j, sink_j, (k_j, v_j) = jax.jit(run)(jnp.asarray(x),
                                            jnp.asarray(pos))
    out_t, sink_t, (k_t, v_t) = L.gqa_attention(
        torch.from_numpy(x), pt, pc, torch.from_numpy(pos), window=window,
        prune_threshold=prune, q_chunk=q_chunk, global_flag=flag)
    for a, b in ((out_t, out_j), (sink_t, sink_j), (k_t, k_j), (v_t, v_j)):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a, b) < F32_RTOL


def test_gqa_attention_bf16_matches_jax(J):
    jc, pc = _configs(J, "chatglm3-6b", "bfloat16")
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    x = np.random.default_rng(3).standard_normal((2, 32, 64))
    xj, xt = _jt(x, "bfloat16")
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)
    out_j, sink_j, _ = jax.jit(lambda x, p: J.L.gqa_attention(
        x, pj, jc, None, p, q_chunk=8))(xj, jnp.asarray(pos))
    out_t, sink_t, _ = L.gqa_attention(xt, pt, pc, torch.from_numpy(pos),
                                       q_chunk=8)
    assert out_t.dtype == torch.bfloat16 and sink_t.dtype == torch.float32
    _assert_bf16_close(out_t, out_j)
    assert _rel(sink_t, sink_j) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_attention_chunked_matches_jax(J, dtype):
    """Against JAX, and against the port's own banded ``gqa_attention``."""
    jc, pc = _configs(J, "hymba-1.5b", dtype)
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    x = np.random.default_rng(4).standard_normal((2, 32, 64))
    xj, xt = _jt(x, dtype)
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)
    out_j = jax.jit(lambda x, p: J.L.swa_attention_chunked(
        x, pj, jc, None, p, 8))(xj, jnp.asarray(pos))
    out_t = L.swa_attention_chunked(xt, pt, pc, torch.from_numpy(pos), 8)
    _close(out_t, out_j, dtype)
    banded, _, _ = L.gqa_attention(xt, pt, pc, torch.from_numpy(pos),
                                   window=8)
    assert _rel(out_t, banded) < (F32_RTOL if dtype == "float32" else 2e-2)
    with pytest.raises(ValueError, match="does not divide"):
        L.swa_attention_chunked(xt, pt, pc, torch.from_numpy(pos), 12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_store_and_load_equal_jitted_jax(J, dtype):
    r = np.random.default_rng(5)
    x = (3.0 * r.standard_normal((4, 8, 2, 16))).astype(np.float32)
    x[0, 0, 0, :4] = [7.0, -7.0, 0.025, -0.075]        # clipped, half-way
    xj, xt = _jt(x, dtype)
    qj = jax.jit(lambda a: J.L._kv_store(a, jnp.int8))(xj)
    qt = L._kv_store(xt, torch.int8)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    lj = jax.jit(J.L._kv_load)(qj)
    lt = L._kv_load(qt)
    assert lt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(lt), _np(lj))
    assert torch.equal(L._kv_store(xt, xt.dtype), xt)


# (model dtype, cache dtype, window): bf16 as served, the int8 grid, a
# float32 model (q and the probabilities take the bf16 detour), float32
# with int8, a banded decode
DECODE_CASES = [("bfloat16", "bfloat16", 0), ("bfloat16", "int8", 0),
                ("float32", "float32", 0), ("float32", "int8", 0),
                ("bfloat16", "bfloat16", 8)]


def _random_cache(r, shape, dtype):
    if dtype == "int8":
        a = r.integers(-127, 128, shape).astype(np.int8)
        return jnp.asarray(a), torch.from_numpy(a)
    return _jt(r.standard_normal(shape).astype(np.float32), dtype)


@pytest.mark.parametrize("dtype,kv_dtype,window", DECODE_CASES)
def test_decode_attention_matches_jax(J, dtype, kv_dtype, window):
    jc, pc = _configs(J, "llama3-8b", dtype)
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    r = np.random.default_rng(6)
    xj, xt = _jt(r.standard_normal((2, 1, 64)), dtype)
    ckj, ckt = _random_cache(r, (2, 24, 2, 16), kv_dtype)
    cvj, cvt = _random_cache(r, (2, 24, 2, 16), kv_dtype)
    out_j, nk_j, nv_j, sink_j = jax.jit(
        lambda x, k, v: J.L.decode_attention(x, pj, jc, None, k, v, 13,
                                             window=window))(xj, ckj, cvj)
    out_t, nk_t, nv_t, sink_t = L.decode_attention(xt, pt, pc, ckt, cvt, 13,
                                                   window=window)
    assert nk_t is ckt and nv_t is cvt                  # written in place
    assert out_t.dtype == xt.dtype and tuple(sink_t.shape) == (2, 1)
    _close(out_t, out_j, dtype)
    assert _rel(sink_t, sink_j) < (F32_RTOL if dtype == "float32" else 1e-2)
    for a, b in ((nk_t, nk_j), (nv_t, nv_j)):
        if kv_dtype == "int8":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, dtype)


def test_decode_attention_f32_takes_the_bf16_detour(J):
    """A float32 model rounds q and the probabilities to bf16 as JAX does:
    without the detour the output sits ~1e-3 away, far past F32_RTOL."""
    jc, pc = _configs(J, "llama3-8b", "float32")
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((2, 1, 64)).astype(np.float32))
    ck = torch.from_numpy(r.standard_normal((2, 24, 2, 16)).astype(
        np.float32))
    cv = torch.from_numpy(r.standard_normal((2, 24, 2, 16)).astype(
        np.float32))
    out, _, _, _ = L.decode_attention(x, pt, pc, ck.clone(), cv.clone(), 13)
    out_j, _, _, _ = jax.jit(lambda x, k, v: J.L.decode_attention(
        x, pj, jc, None, k, v, 13))(jnp.asarray(x.numpy()),
                                    jnp.asarray(ck.numpy()),
                                    jnp.asarray(cv.numpy()))
    # the same step through the slot form, which takes no detour (slot
    # 13 of a linear cache: the same mask)
    exact, _, _, _ = L.decode_attention_slot(x, pt, pc, ck.clone(),
                                             cv.clone(), 13, 13)
    assert _rel(out, out_j) < F32_RTOL
    assert _rel(exact, out_j) > 10 * F32_RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_global", [True, False])
def test_decode_attention_slot_matches_jax(J, dtype, is_global):
    """The ring wrapped: position 21 in 8 slots writes slot 5."""
    jc, pc = _configs(J, "hymba-1.5b", dtype)
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    r = np.random.default_rng(8)
    xj, xt = _jt(r.standard_normal((2, 1, 64)), dtype)
    w = 32 if is_global else 8
    ckj, ckt = _random_cache(r, (2, w, 2, 16), dtype)
    cvj, cvt = _random_cache(r, (2, w, 2, 16), dtype)
    slot, window = (21, 0) if is_global else (21 % 8, 8)
    out_j, nk_j, nv_j, sink_j = jax.jit(
        lambda x, k, v: J.L.decode_attention_slot(
            x, pj, jc, None, k, v, 21, slot, window=window))(xj, ckj, cvj)
    out_t, nk_t, nv_t, sink_t = L.decode_attention_slot(
        xt, pt, pc, ckt, cvt, 21, slot, window=window)
    for a, b in ((out_t, out_j), (nk_t, nk_j), (nv_t, nv_j)):
        _close(a, b, dtype)
    assert _rel(sink_t, sink_j) < (F32_RTOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tips", [False, True])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_ffn_matches_jax(J, activation, tips, dtype):
    arch = "llama3-8b" if activation == "swiglu" else "musicgen-large"
    jc, pc = _configs(J, arch, dtype)
    assert jc.ffn_activation == activation
    jp, tp = _params(J, jc)
    pj, pt = _layer0(jp, tp)
    r = np.random.default_rng(9)
    xj, xt = _jt(r.standard_normal((2, 8, 64)), dtype)
    imp = r.random((2, 8)) < 0.5 if tips else None
    yj = jax.jit(lambda x, m: J.L.ffn(x, pj, activation, None,
                                      tips_important=m))(
        xj, None if imp is None else jnp.asarray(imp))
    yt = L.ffn(xt, pt, activation,
               tips_important=None if imp is None else torch.from_numpy(imp))
    assert yt.dtype == xt.dtype
    _close(yt, yj, dtype)
    if tips:
        y_full = L.ffn(xt, pt, activation)
        assert _rel(yt, y_full) > 1e-3          # the INT6 rows moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tips_precision_mask_equals_jitted_jax(dtype):
    """The TIPS fake-quant of the LM's FFN input, bit for bit: in bfloat16
    the JAX package's 4095 rounds to 4096 and ``x / scale`` to bfloat16
    before it is rounded to an integer."""
    from repro.core import tips as j_tips
    from repro_torch.core import tips as t_tips
    r = np.random.default_rng(17)
    xj, xt = _jt(3.0 * r.standard_normal((2, 8, 64)), dtype)
    imp = r.random((2, 8)) < 0.5
    yj = jax.jit(j_tips.apply_precision_mask)(xj, jnp.asarray(imp))
    yt = t_tips.apply_precision_mask(xt, torch.from_numpy(imp))
    assert yt.dtype == xt.dtype
    np.testing.assert_array_equal(_np(yt), _np(yj))


def test_tips_sink_mask_matches_jax(J):
    jc, pc = _configs(J, "llama3-8b", "float32")
    probs = np.random.default_rng(10).random((2, 4, 8)).astype(
        np.float32) * 0.1
    mj = J.L.tips_sink_mask(None, None, jc, jnp.asarray(probs))
    mt = L.tips_sink_mask(None, None, pc, torch.from_numpy(probs))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


# ----------------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------------
def _jax_dispatch(J, x, router, k, e, cap):
    """The JAX package's routing integers, by its own ops (moe.py)."""
    gates = jax.nn.softmax(jnp.einsum("nd,de->ne", x, router), axis=-1)
    _, top_idx = jax.lax.top_k(gates, k)
    onehot = jax.nn.one_hot(top_idx.reshape(-1), e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    mypos = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(top_idx), np.asarray(mypos), np.asarray(mypos < cap)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("cf", [16.0, 0.25])
def test_moe_ffn_matches_jax(J, arch, cf):
    """Output, aux loss and the routing integers; at capacity factor 0.25
    tokens drop (the same ones), and a dropped token moves its row at
    O(1), so a different drop could not hide under the tolerance."""
    jc, pc = _configs(J, arch, "float32")
    pj = J.moe.init_moe_params(jax.random.PRNGKey(3), jc, jnp.float32)
    pt = convert_lm_params(jax.device_get(pj))
    x = np.random.default_rng(11).standard_normal((2, 32, 64)).astype(
        np.float32)
    yj, aux_j = jax.jit(lambda x: J.moe.moe_ffn(
        x, pj, jc, None, capacity_factor=cf))(jnp.asarray(x))
    yt, aux_t = MOE.moe_ffn(torch.from_numpy(x), pt, pc, capacity_factor=cf)
    assert _rel(yt, yj) < F32_RTOL
    assert abs(float(aux_t) - float(aux_j)) < 1e-5 * abs(float(aux_j))
    n, k, e = 64, pc.top_k, pc.num_experts
    cap = MOE.capacity(pc, n, cf)
    assert cap == max(8, int(k * n * cf) // e)
    top_j, pos_j, keep_j = _jax_dispatch(J, x.reshape(n, 64),
                                         np.asarray(pj["router"]), k, e, cap)
    gates = torch.softmax(torch.from_numpy(x).reshape(n, 64)
                          @ pt["router"], dim=-1)
    top_t = torch.topk(gates, k, dim=-1).indices
    pos_t, keep_t = MOE.dispatch_positions(top_t, e, cap)
    np.testing.assert_array_equal(top_t.numpy(), top_j)
    np.testing.assert_array_equal(pos_t.numpy(), pos_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    if cf < 1:
        assert not keep_t.all()
        y_full, _ = MOE.moe_ffn(torch.from_numpy(x), pt, pc,
                                capacity_factor=16.0)
        assert _rel(yt, y_full) > 0.1
    else:
        assert keep_t.all()


def test_moe_ffn_top4_bf16_within_bound(J):
    """Top-4 in bfloat16: the bound of the docstring."""
    kw = dict(top_k=4, num_experts=8)
    jc, pc = _configs(J, "qwen2-moe-a2.7b", "bfloat16", **kw)
    pj = J.moe.init_moe_params(jax.random.PRNGKey(4), jc, jnp.bfloat16)
    pt = convert_lm_params(jax.device_get(pj))
    xj, xt = _jt(np.random.default_rng(12).standard_normal((2, 32, 64)),
                 "bfloat16")
    yj, _ = jax.jit(lambda x: J.moe.moe_ffn(x, pj, jc, None))(xj)
    yt, _ = MOE.moe_ffn(xt, pt, pc)
    assert yt.dtype == torch.bfloat16
    _assert_bf16_close(yt, yj, share=None)


@pytest.mark.parametrize("dtype,k", [("float32", 2), ("float32", 4),
                                     ("bfloat16", 4), ("bfloat16", 1)])
def test_moe_combine_matches_the_scatter_add(dtype, k):
    """The rank-order combine against the ``index_add_`` scatter by token
    it replaced (which on the CPU adds in index order, so rank order too),
    a fifth of the slots dropped (zeros): within the MoE bounds of the
    docstring (1e-5 in float32; 2 bf16 ulps of the largest value)."""
    r = np.random.default_rng(21)
    n, d = 48, 64
    c = torch.from_numpy(r.standard_normal((n * k, d)).astype(np.float32))
    c[torch.from_numpy(r.random(n * k) < 0.2)] = 0.0
    c = c.to(getattr(torch, dtype))
    tok = torch.arange(n * k) // k
    old = torch.zeros((n, d), dtype=c.dtype).index_add_(0, tok, c)
    new = MOE.combine(c, k)
    assert new.shape == (n, d) and new.dtype == c.dtype
    if dtype == "float32":
        assert _rel(new, old) < F32_RTOL
    else:
        _assert_bf16_close(new, old, share=None)


def test_moe_ffn_two_calls_bit_equal():
    """Top-4 in bfloat16 with drops: two calls give the same output, aux
    and input gradient bit for bit."""
    pc = get_arch("qwen2-moe-a2.7b").smoke().scaled(
        dtype="bfloat16", top_k=4, num_experts=8)
    pt = MOE.init_moe_params(torch.Generator().manual_seed(5), pc,
                             torch.bfloat16)
    x0 = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 32, 64)).astype(np.float32)).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        x = x0.clone().requires_grad_()
        y, aux = MOE.moe_ffn(x, pt, pc, capacity_factor=0.5)
        (y.float().square().sum() + aux).backward()
        runs.append((y.detach(), aux.detach(), x.grad))
    keep = MOE.dispatch_positions(
        torch.topk(torch.softmax(x0.reshape(-1, 64).float() @ pt["router"],
                                 dim=-1), 4, dim=-1).indices, 8,
        MOE.capacity(pc, 64, 0.5))[1]
    assert not keep.all()

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))


# ----------------------------------------------------------------------------
# Every architecture
# ----------------------------------------------------------------------------
def _inputs(cfg, r, b, t):
    """(tokens, embeds): embedding-input architectures take embeds."""
    if cfg.embedding_input:
        return None, r.standard_normal((b, t, cfg.d_model)).astype(
            np.float32)
    return r.integers(0, cfg.vocab_size, (b, t)), None


def _random_decode_cache(r, jcache):
    """numpy values in the shapes and dtypes of the JAX cache tree."""
    def one(a):
        if a.dtype == jnp.int8:
            return r.integers(-127, 128, a.shape).astype(np.int8)
        return (0.5 * r.standard_normal(a.shape)).astype(np.float32)
    return jax.tree.map(one, jcache)


@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_architecture_matches_jax(J, arch, features):
    """float32: forward, prefill (logits and cache), init_cache's tree,
    and a decode_step from a random cache at position 33 (past the
    hybrid window of 16: the ring has wrapped); with PSSA and TIPS off,
    and on as configured (FEATURES_RTOL)."""
    kw = {} if features else {"tips": False, "pssa": False}
    jc, pc = _configs(J, arch, "float32", **kw)
    tol = FEATURES_RTOL if features else F32_RTOL
    jp, tp = _params(J, jc)
    r = np.random.default_rng(13)
    toks, embs = _inputs(jc, r, 2, 32)
    kw_j = {"tokens": None if toks is None else jnp.asarray(toks),
            "embeds": None if embs is None else jnp.asarray(embs)}
    kw_t = {"tokens": None if toks is None else torch.from_numpy(toks),
            "embeds": None if embs is None else torch.from_numpy(embs)}
    lj, _, _ = jax.jit(lambda p, kw: J.T.forward(p, jc, None, remat=False,
                                                 **kw))(jp, kw_j)
    lt, aux, none = T.forward(tp, pc, **kw_t)
    assert none is None and lt.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert tuple(lt.shape) == (2, 32, jc.vocab_size)
    assert _rel(lt, lj) < tol
    plj, pcj = jax.jit(lambda p, kw: J.T.prefill(p, jc, None, **kw))(jp, kw_j)
    plt, pct = T.prefill(tp, pc, **kw_t)
    assert _rel(plt, plj) < tol
    _assert_trees_close(pct, pcj, tol)

    cj = J.T.init_cache(jc, 2, 40)
    ct = T.init_cache(pc, 2, 40, device="cpu")
    _assert_trees_close(ct, cj)
    vals = _random_decode_cache(r, cj)
    cj = jax.tree.map(jnp.asarray, vals)
    ct = convert_lm_params(vals)
    tok = r.integers(0, jc.vocab_size, (2, 1))
    dlj, ncj = jax.jit(lambda p, c, t, pos: J.T.decode_step(
        p, c, t, pos, jc, None))(jp, cj, jnp.asarray(tok),
                                 jnp.asarray(33, jnp.int32))
    dlt, nct = T.decode_step(tp, ct, torch.from_numpy(tok), 33, pc)
    assert tuple(dlt.shape) == (2, 1, jc.vocab_size)
    assert _rel(dlt, dlj) < tol
    _assert_trees_close(nct, ncj, tol)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_architecture_bf16_prefill_matches_jax(J, arch):
    jc, pc = _configs(J, arch, "bfloat16")
    jp, tp = _params(J, jc)
    toks, embs = _inputs(jc, np.random.default_rng(14), 2, 32)
    if embs is not None:
        ej, et = _jt(embs, "bfloat16")
        lj, _ = jax.jit(lambda p, e: J.T.prefill(p, jc, None, embeds=e))(
            jp, ej)
        lt, _ = T.prefill(tp, pc, embeds=et)
    else:
        lj, _ = jax.jit(lambda p, t: J.T.prefill(p, jc, None, tokens=t))(
            jp, jnp.asarray(toks))
        lt, _ = T.prefill(tp, pc, tokens=torch.from_numpy(toks))
    assert bool(torch.isfinite(lt).all())
    assert _rel(lt, lj) < MODEL_BF16_RTOL


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_init_params_fills_every_layer(family):
    """Each stacked leaf is one allocation, filled layer by layer: every
    layer's random leaves differ from every other's."""
    arch = {"dense": "yi-9b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-130m",
            "hybrid": "hymba-1.5b"}[family]
    cfg = get_arch(arch).smoke().scaled(num_layers=3)
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    random_leaves = 0
    for leaf in _leaves(p["layers"]):
        assert leaf.shape[0] == 3 and leaf.is_contiguous()
        if not torch.equal(leaf[0], leaf[1]):
            random_leaves += 1
            assert not torch.equal(leaf[1], leaf[2])
    assert random_leaves >= 4
    again = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(again)))


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_serve_gives_the_jax_greedy_tokens(J, arch, kv_int8):
    """``serve`` in float32 against the JAX serve loop: prefill, a decode
    cache of prompt + new positions holding the prefill KV through
    ``_kv_store``, then greedy jitted decode steps."""
    kw = {"kv_cache_dtype": "int8"} if kv_int8 else {}
    jc, pc = _configs(J, arch, "float32", **kw)
    jp, tp = _params(J, jc)
    prompts = np.random.default_rng(15).integers(0, jc.vocab_size, (3, 20))
    new = 6
    seq, timings = serve_mod.serve(pc, tp, torch.from_numpy(prompts), new)
    assert tuple(seq.shape) == (3, new) and timings["decode_steps"] == new - 1

    def start(p, toks):
        logits, pcache = J.T.prefill(p, jc, None, tokens=toks)
        cache = J.T.init_cache(jc, 3, 20 + new)
        cache = {k: jax.lax.dynamic_update_slice_in_dim(
            cache[k], J.L._kv_store(pcache[k], cache[k].dtype), 0, axis=2)
            for k in ("k", "v")}
        return logits, cache
    logits, cache = jax.jit(start)(jp, jnp.asarray(prompts))
    if kv_int8:
        assert cache["k"].dtype == jnp.int8
    step = jax.jit(lambda p, c, t, pos: J.T.decode_step(p, c, t, pos, jc,
                                                        None))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(new - 1):
        logits, cache = step(jp, cache, tok, jnp.asarray(20 + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    np.testing.assert_array_equal(seq.numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))


def test_hybrid_serve_matches_jax_forward(J):
    """hymba (float32, PSSA and TIPS off, the SSD scan in float32 on both
    sides): every decoded step's logits against JAX ``forward`` on the
    prompt plus the tokens decoded so far, at that position.  The prompt
    (24) passes the smoke window (16), so the ring buffers wrap.  Two
    controls land past the bound: the JAX launcher's zeroed KV cache, and
    a zeroed SSM state."""
    jc, pc = _configs(J, "hymba-1.5b", "float32", tips=False, pssa=False,
                      use_ssd_kernel=True)
    jp, tp = _params(J, jc)
    prompts = torch.from_numpy(
        np.random.default_rng(16).integers(0, jc.vocab_size, (2, 24)))
    new = 6
    seq, _ = serve_mod.serve(pc, tp, prompts, new)
    logits, pcache = T.prefill(tp, pc, tokens=prompts)
    cache = T.decode_cache_from_prefill(pc, pcache, 24 + new)
    # the controls get caches of their own: decode_step writes in place
    no_kv = [dict(c, k=torch.zeros_like(c["k"]), v=torch.zeros_like(c["v"]))
             for c in cache]
    no_state = [dict(c, k=c["k"].clone(), v=c["v"].clone(),
                     ssm=dict(c["ssm"],
                              state=torch.zeros_like(c["ssm"]["state"])))
                for c in cache]
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    controls = [T.decode_step(tp, c, tok, 24, pc)[0]
                for c in (no_kv, no_state)]
    steps, out = [], [tok]
    for i in range(new - 1):
        step, cache = T.decode_step(tp, cache, tok, 24 + i, pc)
        steps.append(step)
        tok = step[:, -1].argmax(dim=-1)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(seq.numpy(), torch.cat(out, 1).numpy())
    full = torch.cat([prompts, seq], dim=1)
    lj, _, _ = jax.jit(lambda p, t: J.T.forward(p, jc, None, tokens=t,
                                                remat=False))(
        jp, jnp.asarray(full.numpy()))
    lj = np.asarray(lj)
    for i, step in enumerate(steps):
        assert _rel(step[:, 0], lj[:, 24 + i]) < HYBRID_SERVE_RTOL, i
    for control in controls:
        assert _rel(control[:, 0], lj[:, 24]) > HYBRID_SERVE_RTOL


def test_decode_cache_from_prefill_lays_out_the_ring():
    """An SWA layer of W slots holds position p at slot p % W for the last
    min(W, T) positions and zeros elsewhere; a global layer holds [0, T)."""
    cfg = get_arch("hymba-1.5b").smoke().scaled(num_layers=3,
                                                dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(1), cfg)
    for t in (37, 9):
        toks = torch.randint(0, cfg.vocab_size, (2, t),
                             generator=torch.Generator().manual_seed(t))
        _, pc = T.prefill(params, cfg, tokens=toks)
        cache = T.decode_cache_from_prefill(cfg, pc, t + 5)
        assert len(cache) == 3
        for i, c in enumerate(cache):
            w = c["k"].shape[1]
            if T._is_global_layer(cfg, i):
                assert w == t + 5
                assert torch.equal(c["k"][:, :t], pc["k"][i])
                assert not c["k"][:, t:].any()
            else:
                assert w == min(16, t + 5)
                for s in range(w):
                    p = max(q for q in range(-w, t) if q % w == s)
                    if p >= 0:
                        assert torch.equal(c["v"][:, s], pc["v"][i][:, p])
                    else:
                        assert not c["v"][:, s].any()
            assert torch.equal(c["ssm"]["state"], pc["ssm"]["state"][i])
            assert torch.equal(c["ssm"]["conv"], pc["ssm"]["conv"][i])
    with pytest.raises(ValueError, match="does not fit"):
        T.decode_cache_from_prefill(cfg, pc, t - 1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_cli_on_cpu(arch, capsys):
    cfg = get_arch(arch)
    extra = (["--kv-int8"] if cfg.family in ("dense", "moe")
             else ["--ssd-kernel"])
    serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "20", "--new-tokens", "3"] + extra)
    out = capsys.readouterr().out
    assert "prefill 2x20" in out and "decode: 3 tokens x 2" in out
