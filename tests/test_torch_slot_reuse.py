"""Port parity: temporal reuse under slot serving and the solver banks.

Covers the ``reuse_scale`` lane of the UNet's reuse branch,
``sampler.sample_scan_reuse(sampler_policy=, sampler_bank=)`` in both
modes, ``DiffusionEngine.generate(sampler_policy=)`` under reuse, the
slot runtime's reuse cache (``init_slots`` / ``admit`` / ``slot_step``)
and ``pipeline.reuse_ratios_from_accum``, on the CPU at smoke widths and
guidance 7.5, against the JAX package.  Inputs are drawn with numpy from
a seed; the JAX package's weights are converted by
``repro_torch.convert``; JAX runs under ``jax.jit``.  The port runs on one
intra-op thread, as ``test_torch_slots.py`` does (ROADMAP Queue 3: torch
on the CPU is not batch-invariant with several).

Tolerances:
* reuse counters, the accumulator's reuse buckets and
  ``reuse_ratios_from_accum``: exact;
* latents: atol 2e-2 with TIPS on and 1e-4 with TIPS off, the limits
  ``test_torch_slots.py`` holds the reference route to (a TIPS INT6 code
  on a rounding boundary flips on an ulp of upstream difference);
* the port against itself (threshold 0 against dense, two slot counts,
  slots against the banked one-shot run): bit for bit.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.core import reuse as j_reuse
from repro.diffusion import sampler as j_sampler
from repro.diffusion import solvers as j_solvers
from repro.diffusion import unet as j_unet
from repro.diffusion.denoiser import make_denoiser as j_make_denoiser
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import (
    reuse_ratios_from_accum as j_reuse_ratios)
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.core import reuse as t_reuse
from repro_torch.diffusion import sampler as t_sampler
from repro_torch.diffusion import solvers as t_solvers
from repro_torch.diffusion import unet as t_unet
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import reuse_ratios_from_accum

TIPS_ATOL, NO_TIPS_ATOL = 2e-2, 1e-4
STEPS = dict(ddim=3, dpm2m=4)       # the bank's step budgets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _guided(bk):
    return dataclasses.replace(bk.SMOKE, ddim=dataclasses.replace(
        bk.SMOKE.ddim, guidance_scale=7.5))


def _with(cfg, **unet):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                             **unet))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def engines():
    """One JAX engine (its random init is the slow part) and its weights
    converted for the port."""
    je = JEngine(_guided(j_bk), key=jax.random.PRNGKey(0))
    params = convert_params(*jax.device_get(
        (je.text_params, je.unet_params, je.vae_params)))
    return je, params


def _j_on(je, cfg):
    """The module's JAX engine, weights shared, on another config."""
    other = copy.copy(je)
    other.cfg = cfg
    other.denoiser = j_make_denoiser(cfg.unet)
    other._compiled, other._slot_compiled = {}, {}
    other._encode_fn = other._decode_fn = other._admit_fn = None
    return other


def _requests(cfg, n, seed=9):
    """(tokens, uncond tokens, latents) numpy batches of n rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.text.vocab_size,
                        (n, cfg.text.max_len)).astype(np.int32)
    toks[:, 0] = 0
    s = cfg.unet.latent_size
    lat = rng.standard_normal((n, s, s, 4)).astype(np.float32)
    return toks, np.zeros_like(toks), lat


def _banks():
    """ddim@3 and dpm2m@4 under ``PhaseSchedule.detail_guard()`` (the
    preset that schedules the reuse_scale lane), in each package."""
    return tuple((s.SamplerPolicy.ddim(STEPS["ddim"]), s.SamplerPolicy.dpm2m(
        STEPS["dpm2m"], phases=s.PhaseSchedule.detail_guard()))
        for s in (j_solvers, t_solvers))


def _reuse_planes(accum):
    return [np.asarray(getattr(accum, f)).astype(np.int64)
            for f in ("reuse_computed", "reuse_total")]


# ---------------------------------------------------------------------------
# The reuse_scale lane
# ---------------------------------------------------------------------------
def test_reuse_scale_lane_matches_jax(engines):
    """One UNet call on a valid cache from the previous call, with per-row
    scales: the port's reuse counters equal JAX's, and the scales move
    them against the unscaled call (the lane has effect)."""
    je, params = engines
    ucfg_j = dataclasses.replace(je.cfg.unet,
                                 reuse_policy=j_reuse.ReusePolicy.temporal(
                                     0.5))
    ucfg_t = dataclasses.replace(t_bk.SMOKE.unet,
                                 reuse_policy=t_reuse.ReusePolicy.temporal(
                                     0.5))
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    lat2 = lat + 0.3 * rng.standard_normal(lat.shape).astype(np.float32)
    ctx = rng.standard_normal((4, 8, 32)).astype(np.float32)
    tvec = np.array([480, 480], np.int32)
    scale = np.array([0.25, 4.0], np.float32)
    kw = dict(tips_active=np.array([True, True]), stats_rows=2,
              cfg_dup=True)

    @jax.jit
    def j_run(lat, lat2, ctx, scale):
        """The second call's stats with the scales and without."""
        cache = j_reuse.reuse_cache_zeros(ucfg_j, 2, use_cfg=True)
        f = j_unet.unet_forward
        _, _, cache = f(je.unet_params, lat, tvec, ctx, ucfg_j,
                        reuse_cache=cache, **kw)
        return tuple(f(je.unet_params, lat2, tvec, ctx, ucfg_j,
                       reuse_cache=cache, overrides=ov, **kw)[1]
                     for ov in (j_solvers.PhaseOverrides(reuse_scale=scale),
                                None))

    def t_run(scale):
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        cache = t_reuse.reuse_cache_zeros(ucfg_t, 2, use_cfg=True)
        f = t_unet.unet_forward
        _, _, cache = f(params["unet"], _t(lat), _t(tvec), _t(ctx), ucfg_t,
                        reuse_cache=cache, **tkw)
        ov = None if scale is None else t_solvers.PhaseOverrides(
            reuse_scale=_t(scale))
        return f(params["unet"], _t(lat2), _t(tvec), _t(ctx), ucfg_t,
                 reuse_cache=cache, overrides=ov, **tkw)[1]

    def computed(stats):
        return np.stack([np.asarray(c.computed) for c in stats.reuse])

    scaled_t, plain_t = computed(t_run(scale)), computed(t_run(None))
    scaled_j, plain_j = j_run(*(jnp.asarray(x)
                                for x in (lat, lat2, ctx, scale)))
    np.testing.assert_array_equal(scaled_t, computed(scaled_j))
    np.testing.assert_array_equal(plain_t, computed(plain_j))
    # a quarter of the threshold computes more of row 0, four times less
    # of row 1, and the rows stay apart
    assert (scaled_t[:, 0] >= plain_t[:, 0]).all()
    assert (scaled_t[:, 1] <= plain_t[:, 1]).all()
    assert not np.array_equal(scaled_t, plain_t)


# ---------------------------------------------------------------------------
# Banked sample_scan_reuse, both modes, and banked generate under reuse
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["temporal", "edit"])
def test_banked_sample_scan_reuse_matches_jax(engines, mode):
    """dpm2m@4 + detail_guard run as a row of the bank: JAX's and the
    port's latents within the route's atol, every reuse counter exact.
    Edit mode replays base caches recorded by the same policy."""
    je, params = engines
    jbank, tbank = _banks()
    thr = 0.3
    toks, un, lat = _requests(t_bk.SMOKE, 1, seed=5)
    j_enc = je._encode_compiled()
    ctx_j, un_j = j_enc(jnp.asarray(toks)), j_enc(jnp.asarray(un))
    ctx_t, un_t = _t(ctx_j), _t(un_j)
    scfg_j, scfg_t = je.cfg.ddim, _guided(t_bk).ddim
    jrp, trp = ((m.ReusePolicy.temporal(thr),
                 m.ReusePolicy.edit(thr, 1.0) if mode == "edit" else None)
                for m in (j_reuse, t_reuse))
    base_j = dataclasses.replace(je.cfg.unet, reuse_policy=jrp[0])
    base_t = dataclasses.replace(t_bk.SMOKE.unet, reuse_policy=trp[0])

    def j_apply(ucfg):
        return lambda lat, t, ctx, act, **kw: j_unet.unet_forward(
            je.unet_params, lat, t, ctx, ucfg, tips_active=act, **kw)

    def t_apply(ucfg):
        return lambda lat, t, ctx, act, **kw: t_unet.unet_forward(
            params["unet"], lat, t, ctx, ucfg, tips_active=act, **kw)

    kw_j = dict(sampler_policy=jbank[1], sampler_bank=jbank)
    kw_t = dict(sampler_policy=tbank[1], sampler_bank=tbank)
    record = mode == "edit"

    @jax.jit
    def j_temporal(lat):
        return j_sampler.sample_scan_reuse(
            j_apply(base_j), lat, ctx_j, un_j, scfg_j,
            reuse_cache=j_reuse.reuse_cache_zeros(base_j, 1, True),
            record_caches=record, **kw_j)

    out_j = j_temporal(jnp.asarray(lat))
    out_t = t_sampler.sample_scan_reuse(
        t_apply(base_t), _t(lat), ctx_t, un_t, scfg_t,
        reuse_cache=t_reuse.reuse_cache_zeros(base_t, 1, True),
        record_caches=record, **kw_t)
    if mode == "edit":
        edit_j = dataclasses.replace(base_j, reuse_policy=jrp[1])
        edit_t = dataclasses.replace(base_t, reuse_policy=trp[1])
        lat2 = lat.copy()
        lat2[:, 4:12, 4:12] += 0.5
        out_j = jax.jit(lambda lat, caches: j_sampler.sample_scan_reuse(
            j_apply(edit_j), lat, ctx_j, un_j, scfg_j, base_caches=caches,
            **kw_j))(jnp.asarray(lat2), out_j[2])
        out_t = t_sampler.sample_scan_reuse(
            t_apply(edit_t), _t(lat2), ctx_t, un_t, scfg_t,
            base_caches=out_t[2], **kw_t)
    (lat_j, st_j), (lat_t, st_t) = out_j[:2], out_t[:2]
    assert st_t.num_steps == STEPS["dpm2m"]
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=0,
                               atol=TIPS_ATOL)
    comp = [c.computed.numpy() for c in st_t.reuse]
    for cj, ct, ctt in zip(st_j.reuse, comp, st_t.reuse):
        np.testing.assert_array_equal(ct, np.asarray(cj.computed))
        np.testing.assert_array_equal(ctt.total.numpy(),
                                      np.asarray(cj.total))
    total = sum(int(c.total.sum()) for c in st_t.reuse)
    assert 0 < sum(int(c.sum()) for c in comp) < total   # reuse happened


def test_sample_scan_reuse_bank_needs_policy(engines):
    _, params = engines
    _, tbank = _banks()
    ucfg = dataclasses.replace(t_bk.SMOKE.unet,
                               reuse_policy=t_reuse.ReusePolicy.temporal())
    toks, un, lat = _requests(t_bk.SMOKE, 1)
    with pytest.raises(ValueError, match="requires sampler_policy"):
        t_sampler.sample_scan_reuse(
            None, _t(lat), torch.zeros((1, 8, 32)), torch.zeros((1, 8, 32)),
            _guided(t_bk).ddim,
            reuse_cache=t_reuse.reuse_cache_zeros(ucfg, 1, True),
            sampler_bank=tbank)


def test_banked_generate_under_reuse_matches_jax(engines):
    """``generate(sampler_policy=, sampler_bank=)`` under temporal reuse:
    JAX's engine and the port's on the same requests; then the port's
    slots drain the same two requests under the bank bit for bit."""
    je, params = engines
    jbank, tbank = _banks()
    jcfg = _with(je.cfg, reuse_policy=j_reuse.ReusePolicy.temporal(0.3))
    tcfg = _with(_guided(t_bk), reuse_policy=t_reuse.ReusePolicy.temporal(
        0.3))
    toks, un, lat = _requests(tcfg, 2, seed=3)
    jo = _j_on(je, jcfg).generate(
        jnp.asarray(toks), None, uncond_tokens=jnp.asarray(un),
        latents=jnp.asarray(lat), sampler_policy=jbank[1],
        sampler_bank=jbank)
    te = TEngine(tcfg, device="cpu", params=params)
    to = te.generate(_t(toks), uncond_tokens=_t(un), latents=_t(lat),
                     sampler_policy=tbank[1], sampler_bank=tbank)
    np.testing.assert_allclose(to.latents.numpy(), np.asarray(jo.latents),
                               rtol=0, atol=TIPS_ATOL)
    for cj, ct in zip(jo.stats.reuse, to.stats.reuse):
        np.testing.assert_array_equal(ct.computed.numpy(),
                                      np.asarray(cj.computed))
    state = te.init_slots(2, bank=tbank)
    assert len(state.reuse_cache.layers) == 9
    for s in range(2):
        state = te.admit(state, s, _t(toks[s:s + 1]),
                         uncond_tokens=_t(un[s:s + 1]),
                         latents=_t(lat[s:s + 1]), policy_index=1)
    while not te.finished_slots(state):
        state = te.slot_step(state)
    assert state.latents.numpy().tobytes() == to.latents.numpy().tobytes()


# ---------------------------------------------------------------------------
# The slot runtime under reuse (the JAX package's three engine cases)
# ---------------------------------------------------------------------------
def test_one_shot_threshold_zero_is_dense(engines):
    je, params = engines
    toks, un, lat = _requests(t_bk.SMOKE, 2)
    dense = TEngine(_guided(t_bk), device="cpu", params=params)
    thr0 = TEngine(_with(_guided(t_bk),
                         reuse_policy=t_reuse.ReusePolicy.temporal(0.0)),
                   device="cpu", params=params)
    out_d = dense.generate(_t(toks), uncond_tokens=_t(un), latents=_t(lat))
    out_r = thr0.generate(_t(toks), uncond_tokens=_t(un), latents=_t(lat))
    assert out_r.images.numpy().tobytes() == out_d.images.numpy().tobytes()
    jo = je.generate(jnp.asarray(toks), None, uncond_tokens=jnp.asarray(un),
                     latents=jnp.asarray(lat))
    np.testing.assert_allclose(out_r.latents.numpy(),
                               np.asarray(jo.latents), rtol=0,
                               atol=TIPS_ATOL)


@pytest.mark.parametrize("tips,atol", [(True, TIPS_ATOL),
                                       (False, NO_TIPS_ATOL)])
def test_slots_under_reuse_match_jax_across_slot_counts(engines, tips,
                                                        atol):
    """Two requests at threshold 1.0 through 2 and 4 slots: the port's
    rows bit-equal across slot counts, JAX's latents within the atol,
    the reuse buckets and ``reuse_ratios_from_accum`` exactly JAX's."""
    je, params = engines
    tcfg = _with(_guided(t_bk), tips=tips,
                 reuse_policy=t_reuse.ReusePolicy.temporal(1.0))
    jcfg = _with(je.cfg, tips=tips,
                 reuse_policy=j_reuse.ReusePolicy.temporal(1.0))
    jeng, teng = _j_on(je, jcfg), TEngine(tcfg, device="cpu", params=params)
    toks, un, lat = _requests(tcfg, 2)

    def run(eng, num_slots, wrap, key):
        st = eng.init_slots(num_slots)
        for i in range(2):
            st = eng.admit(st, i, wrap(toks[i:i + 1]), *key,
                           uncond_tokens=wrap(un[i:i + 1]),
                           latents=wrap(lat[i:i + 1]))
        for _ in range(tcfg.ddim.num_inference_steps):
            st = eng.slot_step(st)
        return st

    t2, t4 = run(teng, 2, _t, ()), run(teng, 4, _t, ())
    j2 = run(jeng, 2, jnp.asarray, (None,))
    assert t2.latents.numpy().tobytes() == t4.latents[:2].numpy().tobytes()
    np.testing.assert_allclose(t2.latents.numpy(), np.asarray(j2.latents),
                               rtol=0, atol=atol)
    for a, b, c in zip(_reuse_planes(t2.accum), _reuse_planes(t4.accum),
                       _reuse_planes(j2.accum)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    ratios = reuse_ratios_from_accum(tcfg, t2.accum)
    assert ratios == j_reuse_ratios(jcfg, j2.accum)
    assert ratios[0] == 0.0 and all(0.0 <= r <= 1.0 for r in ratios)
    assert any(r > 0.0 for r in ratios)           # the cache was reused


def test_admit_invalidates_the_previous_occupant(engines):
    """At threshold 1e9 nothing is recomputed on a valid cache; a request
    admitted into a retired slot still computes every patch of its first
    step, in the port as in JAX."""
    je, params = engines
    tcfg = _with(_guided(t_bk), reuse_policy=t_reuse.ReusePolicy.temporal(
        1e9))
    jcfg = _with(je.cfg, reuse_policy=j_reuse.ReusePolicy.temporal(1e9))
    toks, un, lat = _requests(tcfg, 2)
    deltas = []
    for eng, wrap, key in ((TEngine(tcfg, device="cpu", params=params), _t,
                            ()), (_j_on(je, jcfg), jnp.asarray, (None,))):
        st = eng.init_slots(1)
        st = eng.admit(st, 0, wrap(toks[:1]), *key, uncond_tokens=wrap(
            un[:1]), latents=wrap(lat[:1]))
        st = eng.slot_step(st)
        assert bool(st.reuse_cache.valid[0])
        st = eng.slot_step(st)          # a valid cache: nothing computed
        comp, tot = _reuse_planes(st.accum)
        assert comp[1].sum() == 0 and tot[1].sum() > 0
        st = eng.retire(st, [0])
        st = eng.admit(st, 0, wrap(toks[1:]), *key, uncond_tokens=wrap(
            un[1:]), latents=wrap(lat[1:]))
        assert not bool(st.reuse_cache.valid[0])
        before = _reuse_planes(st.accum)
        st = eng.slot_step(st)
        after = _reuse_planes(st.accum)
        d_comp = int(after[0][0].sum() - before[0][0].sum())
        d_tot = int(after[1][0].sum() - before[1][0].sum())
        assert d_tot > 0 and d_comp == d_tot
        deltas.append((d_comp, d_tot))
    assert deltas[0] == deltas[1]
