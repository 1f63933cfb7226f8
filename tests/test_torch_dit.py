"""Port parity: the denoiser contract and the DiT-S/2 family.

Mirrors the JAX package's ``tests/test_denoiser_contract.py`` on the
port, for both registered families (``unet``, ``dit``):
* ``make_denoiser`` resolves the family from the config type alone, the
  handle is hashable, ``layer_order`` follows the config hook, and an
  unknown config raises;
* ``abstract_params`` gives init's shapes and dtypes without storage;
* the PSSA/TIPS counters are bit-identical across ``reference`` and
  ``fused`` routing at the default operating point;
* the engine reproduces the two-call pipeline loop on the same weights;
* the slot runtime reproduces one-shot ``generate`` at knife-edge
  thresholds (PSSA 1/T, TIPS 1/text_len), also under a solver bank with
  temporal reuse, and a positive control keeps the counters
  input-sensitive.

Then the DiT family against the JAX package on its converted weights,
JAX under ``jax.jit`` with its Pallas kernels in interpret mode, inputs
drawn with numpy from a seed.  Tolerances:
* ``dit_forward``'s eps: rtol 1e-4, atol 1e-5 on the reference route
  (``test_torch_model.py``'s TOL) and atol 2e-3 on the DBSC route (an
  INT12 code on a rounding boundary flips on an ulp upstream); PSSA
  counters and TIPS masks exact;
* 3-step latents and images at ``test_torch_pipeline.py``'s limits
  (1e-4 / 1e-4 reference, 2e-2 / 2e-3 DBSC); the energy summary key for
  key;
* ``dit_ledger`` and the reports built on it: every entry equal;
* DiT under temporal reuse at threshold 0: bit-equal to dense;
* ``convert_params`` on a DiT tree: every leaf bit for bit.
The port runs on one intra-op thread (ROADMAP Queue 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dit_s as j_dit_cfg
from repro.diffusion import denoiser as j_denoiser
from repro.diffusion import dit as j_dit
from repro.diffusion import ledger as j_ledger
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import energy_report as j_report
from repro.kernels.dispatch import KernelPolicy as JKP
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.configs import dit_s as t_dit_cfg
from repro_torch.convert import convert_params, convert_tree
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.reuse import ReusePolicy
from repro_torch.diffusion import dit as t_dit
from repro_torch.diffusion import ledger as t_ledger
from repro_torch.diffusion.denoiser import (FAMILIES, family_of,
                                            make_denoiser)
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                            energy_report,
                                            energy_report_banked,
                                            energy_report_from_accum,
                                            energy_report_multi)
from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
from repro_torch.diffusion.stats import attn_layer_order
from repro_torch.kernels.dispatch import KernelPolicy as TKP

TOL = dict(rtol=1e-4, atol=1e-5)
ROUTES = {
    "reference": (JKP(), TKP(), dict(eps=TOL, lat=1e-4, img=1e-4)),
    "fused_dbsc": (JKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc", interpret=True),
                   TKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc"),
                   dict(eps=dict(rtol=0, atol=2e-3), lat=2e-2, img=2e-3)),
}
SMOKES = {"unet": t_bk.SMOKE, "dit": t_dit_cfg.SMOKE}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _guided(cfg):
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))


def _with(cfg, **unet):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                             **unet))


def _knife_edge(cfg):
    """Thresholds at the smoke models' score scale: the untrained rows
    would otherwise saturate every counter."""
    t = cfg.unet.attn_resolutions()[0] ** 2
    return _with(cfg, pssa_threshold=1.0 / t, precision=PrecisionPolicy(
        threshold=1.0 / cfg.unet.text_len))


def _requests(cfg, n, seed=7):
    """(tokens, uncond tokens, latents) numpy batches of n rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.text.vocab_size,
                        (n, cfg.text.max_len)).astype(np.int32)
    toks[:, 0] = 0
    s = cfg.unet.latent_size
    lat = rng.standard_normal((n, s, s, 4)).astype(np.float32)
    return toks, np.zeros_like(toks), lat


@pytest.fixture(scope="module")
def jax_dit():
    """One JAX engine on the DiT smoke config and its converted weights."""
    je = JEngine(_guided(j_dit_cfg.SMOKE), key=jax.random.PRNGKey(0))
    params = convert_params(*jax.device_get(
        (je.text_params, je.unet_params, je.vae_params)))
    return je, params


# ----------------------------------------------------------------------------
# The handle
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_make_denoiser_resolves_family(family):
    cfg = SMOKES[family]
    den = make_denoiser(cfg.unet)
    assert den.family == family == family_of(cfg.unet)
    assert den.cfg is cfg.unet
    assert {den: 1}[make_denoiser(cfg.unet)] == 1
    assert den.layer_order() == attn_layer_order(cfg.unet)
    assert len(den.layer_order()) > 0
    assert FAMILIES == j_denoiser.FAMILIES


def test_family_of_rejects_unknown_configs():
    with pytest.raises(TypeError, match="no denoiser family"):
        family_of(object())


@pytest.mark.parametrize("family", FAMILIES)
def test_init_params_defaults_to_the_card(family):
    den = make_denoiser(SMOKES[family].unet)
    if torch.cuda.is_available():
        leaf = den.init_params(torch.Generator("cuda").manual_seed(3))
        assert leaf["time_mlp1"]["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            den.init_params(torch.Generator().manual_seed(3))


@pytest.mark.parametrize("family", FAMILIES)
def test_abstract_params_match_init(family):
    den = make_denoiser(SMOKES[family].unet)
    concrete = den.init_params(torch.Generator().manual_seed(3), "cpu")
    abstract = den.abstract_params()
    c_leaves, a_leaves = [], []
    for tree, out in ((concrete, c_leaves), (abstract, a_leaves)):
        jax.tree_util.tree_map(out.append, tree)
    assert len(c_leaves) == len(a_leaves) > 0
    for c, a in zip(c_leaves, a_leaves):
        assert c.shape == a.shape and c.dtype == a.dtype
        assert a.device.type == "meta"


def test_dit_layer_order_and_geometry_match_jax():
    jc, tc = j_dit.DiTConfig(), t_dit.DiTConfig()
    for j, t in ((jc, tc), (jc.smoke(), tc.smoke())):
        assert ([k.name for k in t.layer_order()]
                == [k.name for k in j.layer_order()])
        assert t.attn_resolutions() == j.attn_resolutions()
        assert t.channels_at(t.token_res) == j.channels_at(j.token_res)
    with pytest.raises(ValueError, match="one token resolution"):
        tc.channels_at(32)


# ----------------------------------------------------------------------------
# The contract on the port (both families)
# ----------------------------------------------------------------------------
def _counters(stats):
    leaves = [x for p in stats.pssa for x in p]
    return leaves + [t.low_precision_ratio for t in stats.tips]


@pytest.mark.parametrize("family", FAMILIES)
def test_counters_bit_identical_across_kernel_routing(family):
    cfg = SMOKES[family]
    toks, _, lat = _requests(cfg, 1, seed=1)
    outs = {}
    for routing in ("reference", "fused"):
        c = _with(cfg, kernel_policy=getattr(TKP, routing)())
        eng = TEngine(c, device="cpu", generator=torch.Generator()
                      .manual_seed(0))
        outs[routing] = eng.generate(_t(toks), latents=_t(lat))
    ref, fus = _counters(outs["reference"].stats), _counters(
        outs["fused"].stats)
    assert len(ref) == len(fus)
    for a, b in zip(ref, fus):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_python_loop_pipeline(family):
    cfg = _guided(SMOKES[family])
    pipe = StableDiffusionPipeline(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    params = {"text": pipe.text_params, "unet": pipe.unet_params,
              "vae": pipe.vae_params}
    eng = TEngine(cfg, device="cpu", params=params)
    toks, un, lat = _requests(cfg, 1, seed=2)
    img_loop, _ = pipe.generate(_t(toks), uncond_tokens=_t(un),
                                latents=_t(lat))
    out = eng.generate(_t(toks), uncond_tokens=_t(un), latents=_t(lat))
    assert out.images.shape == img_loop.shape
    assert bool(torch.isfinite(out.images).all())
    torch.testing.assert_close(out.images, img_loop, rtol=1e-3, atol=1e-3)


def _drain_pairs(eng, reqs, bank=None, policy_index=0):
    """Admit the requests two at a time into 2 slots, drain each pair."""
    toks, un, lat = reqs
    state = eng.init_slots(2, bank=bank)
    lats = []
    for i in range(0, toks.shape[0], 2):
        for s in range(2):
            r = slice(i + s, i + s + 1)
            state = eng.admit(state, s, _t(toks[r]), uncond_tokens=_t(un[r]),
                              latents=_t(lat[r]), policy_index=policy_index)
        while not eng.finished_slots(state):
            state = eng.slot_step(state)
        lats.append(state.latents.clone())
        state = eng.retire(state, [0, 1])
    return state, lats


@pytest.mark.parametrize("mode", ["dense", "reuse_banked"])
def test_slot_runtime_matches_one_shot_oracle(jax_dit, mode):
    """DiT served through slots: each admitted pair equals ``generate`` of
    the pair bit for bit (equal batch content), and the accumulator's
    headline equals the one-shot ledger's key for key.  ``reuse_banked``
    serves the dpm2m@4 + detail_guard entry of a bank under temporal
    reuse against the banked one-shot run."""
    cfg = _knife_edge(_guided(t_dit_cfg.SMOKE))
    bank = None
    if mode == "reuse_banked":
        cfg = _with(cfg, reuse_policy=ReusePolicy.temporal(1.0))
        bank = (SamplerPolicy.ddim(3), SamplerPolicy.dpm2m(
            4, phases=PhaseSchedule.detail_guard()))
    eng = TEngine(cfg, device="cpu", params=jax_dit[1])
    reqs = _requests(cfg, 4, seed=8)
    kw = {} if bank is None else dict(sampler_policy=bank[1],
                                      sampler_bank=bank)
    state, lats = _drain_pairs(eng, reqs, bank, 0 if bank is None else 1)
    stats = []
    for i, got in zip((0, 2), lats):
        out = eng.generate(_t(reqs[0][i:i + 2]),
                           uncond_tokens=_t(reqs[1][i:i + 2]),
                           latents=_t(reqs[2][i:i + 2]), **kw)
        assert got.numpy().tobytes() == out.latents.numpy().tobytes()
        stats.append(out.stats)
    if bank is None:
        assert (energy_report_from_accum(cfg, state.accum).summary()
                == energy_report_multi(cfg, stats).summary())
    else:
        entry = energy_report_banked(cfg, state.accum, bank).entries[1]
        assert entry.images == 4
        assert (entry.report.summary() == energy_report_multi(
            cfg, stats, sampler_policy=bank[1]).summary())
        assert 0 < int(state.accum.reuse_computed.sum()) < int(
            state.accum.reuse_total.sum())


def test_knife_edge_counters_are_input_sensitive(jax_dit):
    cfg = _knife_edge(t_dit_cfg.SMOKE)
    eng = TEngine(cfg, device="cpu", params=jax_dit[1])
    outs = [eng.generate(_t(t), latents=_t(lat))
            for t, _, lat in (_requests(cfg, 1, seed=s) for s in (7, 23))]
    nnz = [torch.cat([p.nnz.reshape(-1) for p in o.stats.pssa])
           for o in outs]
    assert not torch.equal(nnz[0], nnz[1])


# ----------------------------------------------------------------------------
# DiT against the JAX package
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("route", list(ROUTES))
def test_dit_forward_matches_jax(jax_dit, route):
    je, params = jax_dit
    jpol, tpol, tol = ROUTES[route]
    jcfg = dataclasses.replace(je.cfg.unet, kernel_policy=jpol)
    tcfg = dataclasses.replace(t_dit_cfg.SMOKE.unet, kernel_policy=tpol)
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    t = np.array([480], np.int32)
    fn = jax.jit(functools.partial(j_dit.dit_forward, cfg=jcfg,
                                   stats_rows=1, cfg_dup=True))
    ej, sj = fn(je.unet_params, jnp.asarray(lat), jnp.asarray(t),
                jnp.asarray(ctx), tips_active=jnp.asarray([True]))
    et, st = t_dit.dit_forward(params["unet"], _t(lat), _t(t), _t(ctx),
                               tcfg, tips_active=torch.tensor([True]),
                               stats_rows=1, cfg_dup=True)
    assert et.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **tol["eps"])
    assert [k.name for k in st.layers] == [k.name for k in sj.layers]
    for a, b in zip(sj.pssa, st.pssa):
        for f in a._fields:
            assert np.asarray(getattr(a, f)).tobytes() == \
                getattr(b, f).numpy().tobytes(), f
    for a, b in zip(sj.tips, st.tips):
        np.testing.assert_array_equal(b.important.numpy(),
                                      np.asarray(a.important))


@pytest.mark.parametrize("route", list(ROUTES))
def test_dit_generate_matches_jax(jax_dit, route):
    je, params = jax_dit
    jpol, tpol, tol = ROUTES[route]
    jcfg = j_dit_cfg.with_kernel_policy(_guided(j_dit_cfg.SMOKE), jpol)
    tcfg = t_dit_cfg.with_kernel_policy(_guided(t_dit_cfg.SMOKE), tpol)
    jeng = JEngine(jcfg, key=jax.random.PRNGKey(0))
    toks, un, lat = _requests(tcfg, 1, seed=0)
    jo = jeng.generate(jnp.asarray(toks), None, uncond_tokens=jnp.asarray(un),
                       latents=jnp.asarray(lat))
    to = TEngine(tcfg, device="cpu", params=params).generate(
        _t(toks), uncond_tokens=_t(un), latents=_t(lat))
    assert to.images.shape == (1, 128, 128, 3) and to.stats.num_steps == 3
    np.testing.assert_allclose(to.latents.numpy(), np.asarray(jo.latents),
                               rtol=0, atol=tol["lat"])
    np.testing.assert_allclose(to.images.numpy(), np.asarray(jo.images),
                               rtol=0, atol=tol["img"])
    assert (energy_report(tcfg, to.stats).summary()
            == j_report(jcfg, jo.stats).summary())


def test_dit_ledger_matches_jax():
    opts = [dict(), dict(pssa=True, tips=True, sas_ratio={16: 0.41},
                         tips_low_ratio=0.37, tips_mid=False, batch=2)]
    jc, tc = j_dit.DiTConfig(), t_dit.DiTConfig()
    for kw in opts:
        jo, to = j_ledger.LedgerOptions(**kw), t_ledger.LedgerOptions(**kw)
        ej, et = j_ledger.dit_ledger(jc, jo), t_ledger.dit_ledger(tc, to)
        assert len(et) == len(ej) == 2 + 3 * tc.depth
        for a, b in zip(ej, et):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (dataclasses.asdict(t_ledger.iteration_report(tc, to))
                == dataclasses.asdict(j_ledger.iteration_report(jc, jo)))
    per_iter = [t_ledger.LedgerOptions(**kw) for kw in opts]
    assert (dataclasses.asdict(t_ledger.generation_report(tc, per_iter))
            == dataclasses.asdict(j_ledger.generation_report(
                jc, [j_ledger.LedgerOptions(**kw) for kw in opts])))
    with pytest.raises(TypeError, match="no denoiser family"):
        t_ledger.denoiser_ledger(object())


@pytest.mark.parametrize("route", ["reference", "fused"])
def test_dit_reuse_threshold_zero_is_dense(jax_dit, route):
    cfg = _with(_guided(t_dit_cfg.SMOKE),
                kernel_policy=getattr(TKP, route)())
    toks, un, lat = _requests(cfg, 2, seed=5)
    dense = TEngine(cfg, device="cpu", params=jax_dit[1]).generate(
        _t(toks), uncond_tokens=_t(un), latents=_t(lat))
    eng = TEngine(_with(cfg, reuse_policy=ReusePolicy.temporal(0.0)),
                  device="cpu", params=jax_dit[1])
    out = eng.generate(_t(toks), uncond_tokens=_t(un), latents=_t(lat))
    assert out.latents.numpy().tobytes() == dense.latents.numpy().tobytes()
    assert len(out.stats.reuse) == eng.cfg.unet.depth
    for c in out.stats.reuse:
        assert torch.equal(c.computed, c.total)


def test_convert_params_takes_a_dit_tree(jax_dit):
    """The DiT tree has no 4-D (conv) leaf, so ``convert_tree`` copies
    every leaf as it is; a conv leaf added to DiT later would need the
    HWIO -> OIHW transpose, and this test names it."""
    je, params = jax_dit
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.device_get(je.unet_params))[0]
    conv = [jax.tree_util.keystr(p) for p, x in flat_j if np.ndim(x) == 4]
    assert conv == [], f"DiT conv leaves {conv}: check convert_tree"
    flat_t = jax.tree_util.tree_flatten_with_path(params["unet"])[0]
    assert ([jax.tree_util.keystr(p) for p, _ in flat_t]
            == [jax.tree_util.keystr(p) for p, _ in flat_j])
    for (_, a), (_, b) in zip(flat_j, flat_t):
        a = np.asarray(a)
        assert b.shape == a.shape and b.numpy().tobytes() == a.tobytes()
    again = convert_tree(jax.device_get(je.unet_params))
    assert torch.equal(again["blocks"][0]["ada"]["w"],
                       params["unet"]["blocks"][0]["ada"]["w"])
