"""Port parity: temporal patch reuse against the JAX package.

Covers ``repro_torch.core.reuse``, the patch-delta op and its four plan
helpers, the fused PSSA route with gathered queries (Tq != Tk), the reuse
branch of the UNet, the temporal and edit samplers and the engine's
capacity guard.  JAX runs under ``jax.jit``, its Pallas patch-delta kernel
in interpret mode; on the CPU the port's ops run their plain versions
(the CUDA kernel runs only on a card: ``tests/test_torch_cuda.py``).
Inputs are made with numpy from a seed; UNet weights are the JAX
package's, converted by ``repro_torch.convert``.

Tolerances:
* patch deltas, gather plans, window masks, cache shapes, PSSA counters
  and reuse counters: exact.  Where a reuse bitmap differs from JAX,
  each differing patch's delta must lie within 1e-6 relative of the
  threshold (a tie), and each side's counters must equal its own bitmap;
* PSSA output with gathered queries: rtol 1e-5, atol 1e-5, as in
  ``test_torch_kernels.py``;
* latents after three guided steps: atol 2e-3, the bound
  ``test_torch_model.py`` states for a TIPS INT6 code flipped by an ulp
  of upstream difference.  These inputs flip one on the dense path too:
  ``sample_scan`` without reuse differs from JAX by 9.9e-4 here, and by
  3.7e-5 with TIPS off.  The port's fused route is held to the JAX
  reference route, since the JAX fused route cannot take gathered
  queries.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.core import attention as j_attention
from repro.core import reuse as j_reuse
from repro.diffusion import sampler as j_sampler
from repro.diffusion import unet as j_unet
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import (
    aggregated_reuse_ratios_per_iter as j_ratios)
from repro.kernels.patch_reuse import ops as j_ops
from repro.kernels.patch_reuse.ref import patch_delta_ref as j_delta_ref
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_tree
from repro_torch.core import reuse as t_reuse
from repro_torch.diffusion import sampler as t_sampler
from repro_torch.diffusion import unet as t_unet
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import (
    aggregated_reuse_ratios_per_iter as t_ratios)
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.kernels.patch_reuse import ops as t_ops
from repro_torch.kernels.patch_reuse.kernel import patch_delta_kernel
from repro_torch.kernels.patch_reuse.ref import patch_delta_ref as t_delta_ref

PSSA_THR = 1.0 / 8192.0
RTOL, ATOL = 1e-5, 1e-5
TIE_REL = 1e-6
ROUTES = {"reference": TKP(), "fused": TKP.fused()}
LATENT_ATOL = 2e-3
SCFG = dict(num_inference_steps=3, guidance_scale=7.5, tips_active_iters=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# ReusePolicy, window masks, cache geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "off", "temporal", "edit", "temporal,threshold=0.02",
    "edit,threshold=0.1,capacity=0.25", "edit,window=4:4:8:8",
    "threshold=0.3,enabled=true"])
def test_reuse_policy_parse_matches_jax(spec):
    pj, pt = j_reuse.ReusePolicy.parse(spec), t_reuse.ReusePolicy.parse(spec)
    assert pt.describe() == pj.describe()
    for n in (1, 4, 7, 16, 64):
        assert pt.cap_patches(n) == pj.cap_patches(n)


@pytest.mark.parametrize("kwargs", [
    dict(threshold=-1.0), dict(capacity=0.0), dict(capacity=1.5),
    dict(apriori_window=(0, 0, 0, 4)), dict(apriori_window=(1, 2, 3))])
def test_reuse_policy_validation_matches_jax(kwargs):
    with pytest.raises(ValueError):
        j_reuse.ReusePolicy(**kwargs)
    with pytest.raises(ValueError):
        t_reuse.ReusePolicy(**kwargs)


@pytest.mark.parametrize("window,res,patch,latent", [
    ((4, 4, 8, 8), 64, 64, 64), ((4, 4, 8, 8), 32, 32, 64),
    ((4, 4, 8, 8), 16, 16, 64), ((0, 0, 1, 1), 16, 16, 16),
    ((3, 5, 7, 2), 8, 16, 16), ((10, 0, 6, 16), 16, 16, 16),
    ((2, 2, 4, 4), 4, 16, 16)])
def test_window_patch_mask_matches_jax(window, res, patch, latent):
    mj = j_reuse.window_patch_mask(window, res, patch, latent)
    mt = t_reuse.window_patch_mask(window, res, patch, latent)
    assert mt == mj and any(mt)


@pytest.mark.parametrize("batch,use_cfg", [(1, True), (2, False),
                                           (2, True)])
def test_reuse_cache_zeros_matches_jax(batch, use_cfg):
    cj = j_reuse.reuse_cache_zeros(j_bk.SMOKE.unet, batch, use_cfg)
    ct = t_reuse.reuse_cache_zeros(t_bk.SMOKE.unet, batch, use_cfg)
    assert ct.valid.shape == cj.valid.shape and not bool(ct.valid.any())
    assert len(ct.layers) == len(cj.layers) == 9
    for lj, lt in zip(cj.layers, ct.layers):
        for f in lj._fields:
            assert tuple(getattr(lt, f).shape) == getattr(lj, f).shape
            assert not bool(getattr(lt, f).any())
    inv = t_reuse.ReuseCache(valid=torch.ones(batch, dtype=torch.bool),
                             layers=ct.layers).invalidate_row(batch - 1)
    assert inv.valid.tolist() == [True] * (batch - 1) + [False]


# ---------------------------------------------------------------------------
# Patch delta and the plan helpers
# ---------------------------------------------------------------------------
def _delta_inputs(rng, b, t, c, patch):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    r = x + (0.05 * rng.standard_normal((b, t, c))).astype(np.float32)
    r[:, :patch] = x[:, :patch]                 # one unchanged patch
    return x, r


@pytest.mark.parametrize("b,t,c,patch", [
    (2, 64, 12, 16), (2, 80, 12, 16), (1, 24, 12, 8), (2, 256, 32, 16),
    (2, 64, 64, 32)])
def test_patch_delta_matches_jax(b, t, c, patch):
    x, r = _delta_inputs(np.random.default_rng(t + c), b, t, c, patch)
    d_ref = np.asarray(jax.jit(j_delta_ref, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(r), patch))
    d_ker, _ = j_ops.patch_delta(jnp.asarray(x), jnp.asarray(r), patch=patch,
                                 threshold=0.1, use_kernel=True,
                                 interpret=True, bp=3)
    _bits_equal(d_ker, d_ref)
    _bits_equal(t_delta_ref(_t(x), _t(r), patch).numpy(), d_ref)
    for pol in (TKP(), TKP.fused()):
        d, active = t_dispatch.patch_delta(pol, _t(x), _t(r), patch=patch,
                                           threshold=0.1)
        _bits_equal(d.numpy(), d_ref)
        np.testing.assert_array_equal(active.numpy(), d_ref >= 0.1)
    assert (d_ref[:, 0] == 0).all() and (d_ref > 0.1).any()


def test_patch_delta_nan_and_inf_match_jax():
    x, r = _delta_inputs(np.random.default_rng(5), 2, 64, 8, 16)
    x[0, 20, 3] = np.nan
    r[1, 40, 0] = np.inf
    d_j = np.asarray(jax.jit(j_delta_ref, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(r), 16))
    d_t = t_delta_ref(_t(x), _t(r), 16).numpy()
    np.testing.assert_array_equal(d_t, d_j)
    assert np.isnan(d_t[0, 1]) and np.isinf(d_t[1, 2])


def test_patch_delta_threshold_zero_all_active():
    x = torch.zeros((1, 32, 4))
    _, active = t_ops.patch_delta(x, x, patch=16, threshold=0.0)
    assert bool(active.all())
    with pytest.raises(ValueError, match="multiple of patch"):
        t_ops.patch_delta(x, x, patch=24, threshold=0.0)


@pytest.mark.parametrize("b,p,cap,patch", [
    (3, 8, 8, 16), (2, 16, 2, 16), (2, 64, 8, 64), (1, 5, 3, 4),
    (4, 4, 1, 16)])
def test_plan_helpers_match_jax(b, p, cap, patch):
    rng = np.random.default_rng(p * cap)
    active = rng.random((b, p)) < 0.3
    active[0] = True                        # identity prefix
    if b > 1:
        active[1] = False                   # nothing active
    c = 6
    x = rng.standard_normal((b, p * patch, c)).astype(np.float32)
    base = rng.standard_normal((b, p * patch, c)).astype(np.float32)
    vals = rng.standard_normal((b, cap * patch, c)).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def j_plan(a, cap, patch, x, base, vals):
        order, gate = j_ops.reuse_plan(a, cap)
        rows = j_ops.plan_token_rows(order, patch)
        gate_rows = jnp.repeat(gate, patch, axis=1)
        return (order, gate, rows, j_ops.gather_rows(x, rows),
                j_ops.scatter_rows(base, rows, vals, gate_rows))

    oj, gj, rj, xj, sj = (np.asarray(v) for v in j_plan(
        jnp.asarray(active), cap, patch, jnp.asarray(x), jnp.asarray(base),
        jnp.asarray(vals)))
    ot, gt = t_ops.reuse_plan(torch.from_numpy(active), cap)
    rt = t_ops.plan_token_rows(ot, patch)
    xt = t_ops.gather_rows(_t(x), rt)
    base_t = _t(base)
    st = t_ops.scatter_rows(base_t, rt, _t(vals),
                            gt.repeat_interleave(patch, dim=1))
    np.testing.assert_array_equal(ot.numpy(), oj)
    np.testing.assert_array_equal(gt.numpy(), gj)
    np.testing.assert_array_equal(rt.numpy(), rj)
    _bits_equal(xt.numpy(), xj)
    _bits_equal(st.numpy(), sj)
    _bits_equal(base_t.numpy(), base)          # the cache is not modified
    np.testing.assert_array_equal(ot[0].numpy(), np.arange(cap))


# ---------------------------------------------------------------------------
# PSSA self-attention with gathered queries (Tq != Tk)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["reference", "fused"])
@pytest.mark.parametrize("b,h,t,d,patch,cap,stats_rows", [
    (1, 2, 64, 8, 16, 1, None), (2, 4, 256, 8, 16, 2, 1),
    (2, 4, 256, 8, 16, 5, None), (1, 4, 64, 16, 16, 4, None)])
def test_pssa_gathered_queries_match_jax_reference(route, b, h, t, d, patch,
                                                   cap, stats_rows):
    rng = np.random.default_rng(t + cap)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) * 2.0
               for _ in range(3))
    active = rng.random((b, t // patch)) < 0.5
    order, _ = t_ops.reuse_plan(torch.from_numpy(active), cap)
    rows = t_ops.plan_token_rows(order, patch).numpy()
    qg = np.take_along_axis(q, rows[:, None, :, None], axis=2)
    assert qg.shape[2] == cap * patch
    fn = jax.jit(functools.partial(j_attention.self_attention_pssa,
                                   patch=patch, threshold=PSSA_THR,
                                   stats_rows=stats_rows))
    out_j, st_j = fn(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v))
    out_t, st_t = t_dispatch.self_attention(
        TKP.fused() if route == "fused" else TKP(), _t(qg), _t(k), _t(v),
        patch=patch, threshold=PSSA_THR, stats_rows=stats_rows)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)
    for f in st_j._fields:                   # nnz, bitmap_ones_xor, bytes
        _bits_equal(getattr(st_t, f).numpy(), getattr(st_j, f))
    assert 0 < float(st_t.nnz) < float(st_t.total)


# ---------------------------------------------------------------------------
# The UNet reuse branch
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_params():
    jp = j_unet.init_unet_params(jax.random.PRNGKey(1), j_bk.SMOKE.unet)
    return jp, convert_tree(jax.device_get(jp))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    cfg = t_bk.SMOKE.unet
    s = cfg.latent_size
    lat = rng.standard_normal((1, s, s, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.context_dim)) \
        .astype(np.float32)
    un = rng.standard_normal((1, cfg.text_len, cfg.context_dim)) \
        .astype(np.float32)
    return lat, ctx, un


def _tcfg(policy, reuse):
    return dataclasses.replace(t_bk.SMOKE.unet, kernel_policy=policy,
                               reuse_policy=reuse)


@pytest.mark.parametrize("route", list(ROUTES))
def test_unet_reuse_threshold_zero_is_dense(unet_params, inputs, route):
    _, tp = unet_params
    lat, ctx, un = inputs
    pol = ROUTES[route]
    ctx_f = _t(np.concatenate([ctx, un]))
    t = torch.tensor([480])
    kw = dict(tips_active=torch.tensor([True]), stats_rows=1, cfg_dup=True)
    eps_d, st_d = t_unet.unet_forward(tp, _t(lat), t, ctx_f,
                                      _tcfg(pol, t_reuse.ReusePolicy()), **kw)
    rcfg = _tcfg(pol, t_reuse.ReusePolicy.temporal(0.0))
    cache = t_reuse.reuse_cache_zeros(rcfg, 1, use_cfg=True)
    eps_r, st_r, cache2 = t_unet.unet_forward(tp, _t(lat), t, ctx_f, rcfg,
                                              reuse_cache=cache, **kw)
    _bits_equal(eps_r.numpy(), eps_d.numpy())
    assert st_d.reuse == () and len(st_r.reuse) == 9
    for a, b in zip(st_d.pssa, st_r.pssa):
        for f in a._fields:
            _bits_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
    for c in st_r.reuse:
        assert torch.equal(c.computed, c.total)
    assert bool(cache2.valid.all())
    # again against the VALID cache just written: still every patch
    eps_r2, st_r2, _ = t_unet.unet_forward(tp, _t(lat), t, ctx_f, rcfg,
                                           reuse_cache=cache2, **kw)
    _bits_equal(eps_r2.numpy(), eps_d.numpy())
    assert all(torch.equal(c.computed, c.total) for c in st_r2.reuse)


def test_unet_full_reuse_replays_the_cache(unet_params, inputs):
    """At a threshold nothing reaches, a valid cache from the same input
    gives the dense output; a corrupted cache row moves it (the check
    above can see a stale cache)."""
    _, tp = unet_params
    lat, ctx, un = inputs
    ctx_f = _t(np.concatenate([ctx, un]))
    t = torch.tensor([480])
    kw = dict(tips_active=torch.tensor([True]), stats_rows=1, cfg_dup=True)
    rcfg = _tcfg(TKP(), t_reuse.ReusePolicy.temporal(1e9))
    cache0 = t_reuse.reuse_cache_zeros(rcfg, 1, use_cfg=True)
    eps_a, _, cache = t_unet.unet_forward(tp, _t(lat), t, ctx_f, rcfg,
                                          reuse_cache=cache0, **kw)
    eps_b, st_b, _ = t_unet.unet_forward(tp, _t(lat), t, ctx_f, rcfg,
                                         reuse_cache=cache, **kw)
    _bits_equal(eps_b.numpy(), eps_a.numpy())
    assert sum(int(c.computed.sum()) for c in st_b.reuse) == 0
    bad = list(cache.layers)
    bad[3] = bad[3]._replace(ffn=bad[3].ffn + 1.0)
    eps_c, _, _ = t_unet.unet_forward(
        tp, _t(lat), t, ctx_f, rcfg,
        reuse_cache=dataclasses.replace(cache, layers=tuple(bad)), **kw)
    assert not torch.equal(eps_c, eps_a)


# ---------------------------------------------------------------------------
# Samplers: temporal (cache carried) and edit (base caches replayed)
# ---------------------------------------------------------------------------
def _jcfg(reuse):
    return dataclasses.replace(j_bk.SMOKE.unet, reuse_policy=reuse)


def _j_apply(jp, ucfg):
    def apply(lat, t, ctx, active, **kw):
        return j_unet.unet_forward(jp, lat, t, ctx, ucfg, tips_active=active,
                                   **kw)
    return apply


def _t_apply(tp, ucfg):
    def apply(lat, t, ctx, active, **kw):
        return t_unet.unet_forward(tp, lat, t, ctx, ucfg, tips_active=active,
                                   **kw)
    return apply


def _deltas(cur, prev, patch):
    rows, t, c = cur.shape
    return np.abs(cur - prev).reshape(rows, t // patch, patch * c).max(-1)


def _assert_counters_or_ties(cfg, stats_j, stats_t, refs_j, refs_t, thr):
    """Per layer and step: each side's computed counters equal its own
    bitmap (delta >= thr, cond rows), and the bitmaps differ only on
    patches within TIE_REL of thr.  Step 0 runs on an invalid cache."""
    for li, lk in enumerate(stats_t.layers):
        patch = cfg.patch_size(lk.resolution)
        cj = np.asarray(stats_j.reuse[li].computed)
        ct = stats_t.reuse[li].computed.numpy()
        tot = np.asarray(stats_j.reuse[li].total)
        np.testing.assert_array_equal(stats_t.reuse[li].total.numpy(), tot)
        np.testing.assert_array_equal(cj[0], tot[0])
        np.testing.assert_array_equal(ct[0], tot[0])
        rows = cj.shape[1]
        for i in range(1, cj.shape[0]):
            dj = _deltas(refs_j[li][i], refs_j[li][i - 1], patch)[:rows]
            dt = _deltas(refs_t[li][i], refs_t[li][i - 1], patch)[:rows]
            aj, at = dj >= thr, dt >= thr
            np.testing.assert_array_equal(cj[i], aj.sum(1))
            np.testing.assert_array_equal(ct[i], at.sum(1))
            flip = aj != at
            assert np.all(np.abs(dj[flip] - thr) <= TIE_REL * thr), \
                (lk.name, i, dj[flip])


TEMPORAL_THR = 0.05
EDIT = dict(threshold=0.05, capacity=0.25)


def _renoised(lat):
    """The input with its latent window [4:12, 4:12] drawn anew."""
    lat2 = lat.copy()
    lat2[:, 4:12, 4:12, :] = np.random.default_rng(12).standard_normal(
        (1, 8, 8, 4)).astype(np.float32)
    return lat2


@pytest.fixture(scope="module")
def jax_temporal(unet_params, inputs):
    """JAX temporal run at TEMPORAL_THR, caches recorded."""
    jp, _ = unet_params
    jcfg = _jcfg(j_reuse.ReusePolicy.temporal(TEMPORAL_THR))
    scfg = j_sampler.DDIMConfig(**SCFG)

    @jax.jit
    def run(lat, ctx, un):
        cache = j_reuse.reuse_cache_zeros(jcfg, 1, use_cfg=True)
        return j_sampler.sample_scan_reuse(
            _j_apply(jp, jcfg), lat, ctx, un, scfg, reuse_cache=cache,
            record_caches=True)

    return run(*(jnp.asarray(x) for x in inputs))


@pytest.fixture(scope="module")
def jax_edit(unet_params, inputs):
    """JAX base record (threshold 0) and two edit replays: the same input
    and a re-noised window."""
    jp, _ = unet_params
    lat, ctx, un = (jnp.asarray(x) for x in inputs)
    scfg = j_sampler.DDIMConfig(**SCFG)
    base = _jcfg(j_reuse.ReusePolicy.temporal(0.0))
    edit = _jcfg(j_reuse.ReusePolicy.edit(**EDIT))

    @jax.jit
    def record(lat):
        cache = j_reuse.reuse_cache_zeros(base, 1, use_cfg=True)
        return j_sampler.sample_scan_reuse(
            _j_apply(jp, base), lat, ctx, un, scfg, reuse_cache=cache,
            record_caches=True)

    @jax.jit
    def replay(lat, caches):
        return j_sampler.sample_scan_reuse(
            _j_apply(jp, edit), lat, ctx, un, scfg, base_caches=caches)

    lat_b, _, caches = record(lat)
    return (lat_b, replay(lat, caches),
            replay(jnp.asarray(_renoised(inputs[0])), caches))


@pytest.mark.parametrize("route", list(ROUTES))
def test_sample_scan_reuse_temporal_matches_jax(unet_params, inputs,
                                                jax_temporal, route):
    _, tp = unet_params
    lat, ctx, un = inputs
    scfg = t_sampler.DDIMConfig(**SCFG)
    tcfg = _tcfg(ROUTES[route], t_reuse.ReusePolicy.temporal(TEMPORAL_THR))
    lat_j, st_j, caches_j = jax_temporal
    lat_t, st_t, caches_t = t_sampler.sample_scan_reuse(
        _t_apply(tp, tcfg), _t(lat), _t(ctx), _t(un), scfg,
        reuse_cache=t_reuse.reuse_cache_zeros(tcfg, 1, use_cfg=True),
        record_caches=True)
    assert st_t.num_steps == 3 and len(caches_t) == 3
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=0,
                               atol=LATENT_ATOL)
    refs_j = [np.asarray(lc.ref) for lc in caches_j.layers]
    refs_t = [np.stack([c.layers[li].ref.numpy() for c in caches_t])
              for li in range(len(st_t.layers))]
    _assert_counters_or_ties(tcfg, st_j, st_t, refs_j, refs_t,
                             TEMPORAL_THR)
    pcfg_j = dataclasses.replace(j_bk.SMOKE, ddim=j_sampler.DDIMConfig(
        **SCFG))
    pcfg_t = dataclasses.replace(t_bk.SMOKE, ddim=scfg)
    ratios_t = t_ratios(pcfg_t, [st_t])
    if all(np.array_equal(np.asarray(a.computed), b.computed.numpy())
           for a, b in zip(st_j.reuse, st_t.reuse)):
        assert ratios_t == j_ratios(pcfg_j, [st_j])
    assert ratios_t[0] == 0.0 and len(ratios_t) == 3


@pytest.mark.parametrize("route", list(ROUTES))
def test_edit_record_and_replay_match_jax(unet_params, inputs, jax_edit,
                                          route):
    _, tp = unet_params
    lat, ctx, un = inputs
    scfg = t_sampler.DDIMConfig(**SCFG)
    base_t = _tcfg(ROUTES[route], t_reuse.ReusePolicy.temporal(0.0))
    edit_t = _tcfg(ROUTES[route], t_reuse.ReusePolicy.edit(**EDIT))
    lat_bj, (lat_ej, st_ej), (_, st_pj) = jax_edit
    lat_bt, _, caches_t = t_sampler.sample_scan_reuse(
        _t_apply(tp, base_t), _t(lat), _t(ctx), _t(un), scfg,
        reuse_cache=t_reuse.reuse_cache_zeros(base_t, 1, use_cfg=True),
        record_caches=True)

    # the same input: nothing computed, the base latents exactly
    lat_et, st_et = t_sampler.sample_scan_reuse(
        _t_apply(tp, edit_t), _t(lat), _t(ctx), _t(un), scfg,
        base_caches=caches_t)
    assert np.array_equal(np.asarray(lat_ej), np.asarray(lat_bj))
    _bits_equal(lat_et.numpy(), lat_bt.numpy())
    assert sum(int(c.computed.sum()) for c in st_et.reuse) == 0
    assert sum(int(jnp.sum(c.computed)) for c in st_ej.reuse) == 0

    # a re-noised window: at most cap patches per layer, the same counts
    lat_pt, st_pt = t_sampler.sample_scan_reuse(
        _t_apply(tp, edit_t), _t(_renoised(lat)), _t(ctx), _t(un), scfg,
        base_caches=caches_t)
    assert not torch.equal(lat_pt, lat_bt)
    for lk, cj, ct, sp in zip(st_pt.layers, st_pj.reuse, st_pt.reuse,
                              st_pt.pssa):
        patch = edit_t.patch_size(lk.resolution)
        cap = edit_t.reuse_policy.cap_patches(lk.resolution ** 2 // patch)
        np.testing.assert_array_equal(ct.computed.numpy(),
                                      np.asarray(cj.computed))
        assert int(ct.computed.max()) <= cap
        # the self-attention ran on cap * patch gathered queries
        tq = sp.total / (edit_t.num_heads * lk.resolution ** 2)
        assert bool((tq == cap * patch).all())
    assert sum(int(c.computed.sum()) for c in st_pt.reuse) > 0


def test_edit_window_skips_the_patch_delta(unet_params, inputs,
                                           monkeypatch):
    _, tp = unet_params
    lat, ctx, un = inputs
    scfg_t = t_sampler.DDIMConfig(**SCFG)
    base_t = _tcfg(TKP.fused(), t_reuse.ReusePolicy.temporal(0.0))
    _, _, caches = t_sampler.sample_scan_reuse(
        _t_apply(tp, base_t), _t(lat), _t(ctx), _t(un), scfg_t,
        reuse_cache=t_reuse.reuse_cache_zeros(base_t, 1, use_cfg=True),
        record_caches=True)
    win = t_reuse.ReusePolicy.parse("edit,capacity=0.25,window=4:4:8:8")
    calls = []
    orig = t_dispatch.patch_delta
    monkeypatch.setattr(t_dispatch, "patch_delta",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _, st = t_sampler.sample_scan_reuse(
        _t_apply(tp, _tcfg(TKP.fused(), win)), _t(_renoised(lat)), _t(ctx),
        _t(un), scfg_t, base_caches=caches)
    assert calls == []
    for lk, c in zip(st.layers, st.reuse):
        mask = t_reuse.window_patch_mask((4, 4, 8, 8), lk.resolution, 16, 16)
        want = min(sum(mask), win.cap_patches(len(mask)))
        assert (c.computed == want).all()


def test_sample_scan_reuse_needs_one_cache_source(unet_params, inputs):
    _, tp = unet_params
    lat, ctx, un = inputs
    scfg_t = t_sampler.DDIMConfig(**SCFG)
    ucfg = _tcfg(TKP(), t_reuse.ReusePolicy.temporal())
    with pytest.raises(ValueError, match="exactly one"):
        t_sampler.sample_scan_reuse(_t_apply(tp, ucfg), _t(lat), _t(ctx),
                                    _t(un), scfg_t)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
def test_engine_rejects_sub_one_capacity_like_jax():
    for bk, engine, rp, kw in (
            (j_bk, JEngine, j_reuse.ReusePolicy, {}),
            (t_bk, TEngine, t_reuse.ReusePolicy, {"device": "cpu"})):
        cfg = dataclasses.replace(bk.SMOKE, unet=dataclasses.replace(
            bk.SMOKE.unet, reuse_policy=rp.edit(0.05, 0.5)))
        with pytest.raises(ValueError, match="capacity"):
            engine(cfg, **kw)
    ok = dataclasses.replace(t_bk.SMOKE, unet=dataclasses.replace(
        t_bk.SMOKE.unet, reuse_policy=t_reuse.ReusePolicy.temporal()))
    assert TEngine(ok, device="cpu").cfg.unet.reuse_policy.enabled


def test_engine_generate_takes_the_reuse_path():
    cfg = dataclasses.replace(t_bk.SMOKE, unet=dataclasses.replace(
        t_bk.SMOKE.unet, reuse_policy=t_reuse.ReusePolicy.temporal(0.0)))
    dense = TEngine(t_bk.SMOKE, device="cpu")
    params = {"text": dense.text_params, "unet": dense.unet_params,
              "vae": dense.vae_params}
    toks = torch.zeros((1, 8), dtype=torch.int32)
    lat = _t(np.random.default_rng(3).standard_normal((1, 16, 16, 4))
             .astype(np.float32))
    out_d = dense.generate(toks, latents=lat)
    out_r = TEngine(cfg, device="cpu", params=params).generate(toks,
                                                               latents=lat)
    _bits_equal(out_r.latents.numpy(), out_d.latents.numpy())
    assert out_d.stats.reuse == () and len(out_r.stats.reuse) == 9
    assert out_r.stats.reuse[0].computed.shape == (3, 1)
    assert t_ratios(cfg, [out_r.stats]) == [0.0, 0.0, 0.0]
    assert t_ratios(cfg, [out_d.stats]) == [0.0, 0.0, 0.0]


def test_patch_delta_kernel_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        patch_delta_kernel(x, x)
