"""Port parity: the phase-aware sampling runtime (``repro_torch.diffusion.
solvers``, DESIGN.md §10) against ``repro.diffusion.solvers``.

Policies and phase schedules: parse round trips and validation errors
equal the JAX package's (messages included).  Coefficient tables for
budgets 1–50, uniform and Karras, every solver, against the JAX
package's jitted tables (what its engine gathers):
* from the same float32 ``alphas_cumprod`` (the JAX package's): integer
  columns (timesteps, Karras included), the alpha gathers and the scales
  exact; ``c_lat`` at rtol 2e-6; ``c_d`` and ``m2`` at rtol 5e-6 — both go
  through ``h = lambda_next - lambda``, a difference of two logs, and one
  ulp of a log (XLA's against torch's) reads up to 3.5e-6 of h;
* from the port's own alphas (ROADMAP Queue 3 item 1, a few ulps apart):
  the alpha gathers at rtol 2e-6; uniform timesteps exact; a Karras
  timestep may differ only where the ramp's sigma sits within 1e-5 of the
  midpoint of two adjacent training sigmas (a tie that an ulp of the
  alphas decides).
Engine contracts on the port at smoke widths, guidance 7.5, one intra-op
thread (``test_torch_slots.py`` says why): a single-policy ddim bank and a
neutral phase schedule are bit-equal to the legacy ``generate``; a
mixed-bank slot trace is bit-equal to banked one-shot runs.  The banked
ledger (``energy_report_banked``, ``phase_breakdown_from_accum``) equals
the JAX package's on the same integer buckets, and a ``pssa_scale`` bank
takes the reference self-attention route, as the JAX dispatch does.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as j_attention
from repro.diffusion import pipeline as j_pipeline
from repro.diffusion import solvers as J
from repro.diffusion.sampler import DDIMConfig as JDDIM
from repro.diffusion.sampler import alphas_cumprod as j_alphas
from repro.diffusion.stats import LedgerAccum as JAccum
from repro.kernels import dispatch as j_dispatch
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.core import attention as t_attention
from repro_torch.diffusion import pipeline as t_pipeline
from repro_torch.diffusion import solvers as T
from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.diffusion.pipeline import init_params
from repro_torch.diffusion.sampler import DDIMConfig as TDDIM
from repro_torch.diffusion.stats import LedgerAccum, attn_layer_order
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels.dispatch import KernelPolicy

SPECS = ["draft", "balanced", "quality", "ddim", "plms", "dpm2m",
         "dpm2m,steps=10,phases=detail_guard",
         "solver=plms,steps=6,name=fast",
         "ddim,phases=boundaries=0.3:0.6;pssa=2:2:1",
         "dpm2m,steps=10,schedule=karras",
         "plms,steps=7,phases=tips=on:off:on;tips_scale=2:1:0.5;reuse=1:3:1"]

ERRORS = [
    lambda m: m.SamplerPolicy(solver="euler"),
    lambda m: m.SamplerPolicy(num_steps=0),
    lambda m: m.SamplerPolicy(schedule="cosine"),
    lambda m: m.SamplerPolicy.tier("ultra"),
    lambda m: m.SamplerPolicy.parse("ddim,foo=1"),
    lambda m: m.SamplerPolicy.parse("bogus"),
    lambda m: m.PhaseSchedule(boundaries=(0.8, 0.4)),
    lambda m: m.PhaseSchedule(pssa_scale=(1.0, 0.0, 1.0)),
    lambda m: m.PhaseSchedule.parse("boundaries=0.3"),
    lambda m: m.PhaseSchedule.parse("pssa=1:2"),
    lambda m: m.PhaseSchedule.parse("foo=1:2:3"),
    lambda m: m.PhaseSchedule.parse("pssa"),
    lambda m: m.as_bank(()),
    lambda m: m.as_bank(("ddim",)),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Policies, schedules, bank views
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_policy_parse_matches_jax(spec):
    pj, pt = J.SamplerPolicy.parse(spec), T.SamplerPolicy.parse(spec)
    assert pt.describe() == pj.describe()
    assert (pt.key(), pt.label(), pt.history, pt.solver_id) == \
        (pj.key(), pj.label(), pj.history, pj.solver_id)
    assert dataclasses.replace(pt, name="other") == pt
    ddim = JDDIM()
    assert T.tips_active_schedule(pt, TDDIM()) == \
        J.tips_active_schedule(pj, ddim)
    assert T.phase_index_schedule(pt) == J.phase_index_schedule(pj)


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_validation_errors_match_jax(case):
    with pytest.raises(Exception) as ej:
        ERRORS[case](J)
    with pytest.raises(Exception) as et:
        ERRORS[case](T)
    assert type(et.value) is type(ej.value)

    def text(e):      # a generator's repr carries its address
        return re.sub(r" at 0x[0-9a-f]+", "", str(e.value))
    assert text(et) == text(ej)


@pytest.mark.parametrize("n", [1, 3, 7, 12, 25, 50])
def test_phase_schedule_views_match_jax(n):
    for ph_j, ph_t in ((J.PhaseSchedule(), T.PhaseSchedule()),
                       (J.PhaseSchedule.detail_guard(),
                        T.PhaseSchedule.detail_guard()),
                       (J.PhaseSchedule.parse("boundaries=0.3:0.6"),
                        T.PhaseSchedule.parse("boundaries=0.3:0.6"))):
        assert [ph_t.phase_of(i, n) for i in range(n)] == \
            [ph_j.phase_of(i, n) for i in range(n)]
        assert ph_t.describe() == ph_j.describe()
        assert (ph_t.schedules_pssa, ph_t.schedules_tips_threshold,
                ph_t.schedules_reuse) == (ph_j.schedules_pssa,
                                          ph_j.schedules_tips_threshold,
                                          ph_j.schedules_reuse)


def test_bank_views_and_plms_weights_match_jax():
    specs = ("ddim,steps=3", "dpm2m,steps=4,phases=detail_guard",
             "plms,steps=2,phases=tips_scale=2:1:1")
    bj = J.as_bank(tuple(J.SamplerPolicy.parse(s) for s in specs))
    bt = T.as_bank(tuple(T.SamplerPolicy.parse(s) for s in specs))
    for fn in ("bank_max_steps", "bank_history", "bank_schedules"):
        assert getattr(T, fn)(bt) == getattr(J, fn)(bj)
    assert T.as_bank(T.SamplerPolicy.ddim(3)) == (T.SamplerPolicy.ddim(3),)
    assert T.PLMS_WEIGHTS == J.PLMS_WEIGHTS
    assert T.SOLVER_ID == J.SOLVER_ID
    assert ({k: v.describe() for k, v in T.TIERS.items()}
            == {k: v.describe() for k, v in J.TIERS.items()})
    for row in T.PLMS_WEIGHTS:
        assert abs(sum(row) - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# Coefficient tables against the JAX package's jitted tables
# ---------------------------------------------------------------------------
INT_COLS = ("t", "tips", "solver", "budget")


def _banks(schedule):
    pols = [(J.SOLVERS[n % 3], n) for n in range(1, 51)]
    return (tuple(J.SamplerPolicy(solver=s, num_steps=n, schedule=schedule)
                  for s, n in pols),
            tuple(T.SamplerPolicy(solver=s, num_steps=n, schedule=schedule)
                  for s, n in pols))


@pytest.mark.parametrize("schedule", ["uniform", "karras"])
def test_solver_tables_match_jax(schedule):
    bj, bt = _banks(schedule)
    ddim_j, ddim_t = JDDIM(), TDDIM()
    tj = jax.jit(lambda: J.solver_tables(bj, ddim_j))()
    acp_j = np.asarray(jax.jit(lambda: j_alphas(ddim_j))())
    col = {f: np.asarray(getattr(tj, f)) for f in tj._fields}

    same = T.tables_from_alphas(bt, ddim_t, torch.from_numpy(acp_j.copy()))
    for f in tj._fields:
        got = getattr(same, f).numpy()
        if f in INT_COLS + ("a_t", "a_prev", "pssa_scale", "tips_scale",
                            "reuse_scale"):
            np.testing.assert_array_equal(got, col[f].astype(got.dtype),
                                          err_msg=f)
        else:
            rtol = 2e-6 if f == "c_lat" else 5e-6
            np.testing.assert_allclose(got, col[f], rtol=rtol, atol=0,
                                       err_msg=f)

    own = T.solver_tables(bt, ddim_t)
    t_own = own.t.numpy()
    agree = t_own == col["t"]
    # a_prev reads the next boundary's timestep
    agree_next = agree & np.concatenate([agree[:, 1:], agree[:, -1:]], 1)
    for f, mask in (("a_t", agree), ("a_prev", agree_next)):
        np.testing.assert_allclose(getattr(own, f).numpy()[mask],
                                   col[f][mask], rtol=2e-6, atol=0,
                                   err_msg=f)
    flips = np.argwhere(~agree)
    assert schedule == "karras" or len(flips) == 0
    sig = np.sqrt((1.0 - acp_j.astype(np.float64)) / acp_j)
    rho = J.KARRAS_RHO
    for p, i in flips:
        n = bj[p].num_steps
        ramp = i / (n - 1)
        target = (sig[-1] ** (1 / rho) + ramp * (sig[0] ** (1 / rho)
                                                 - sig[-1] ** (1 / rho))) ** rho
        a, b = sorted((int(t_own[p, i]), int(col["t"][p, i])))
        assert b == a + 1, (p, i, a, b)
        mid = 0.5 * (sig[a] + sig[b])
        assert abs(target - mid) <= 1e-5 * mid, (p, i, target, mid)
    assert len(flips) <= 4


def test_dpm2m_final_step_lands_on_x0():
    """The final sigma is 0 and h = inf; expm1(-inf) = -1 lands the step on
    the data prediction with no NaN."""
    bank = (T.SamplerPolicy.dpm2m(4),)
    tab = T.solver_tables(bank, TDDIM())
    assert float(tab.c_lat[0, 3]) == 0.0 and float(tab.c_d[0, 3]) == 1.0
    assert float(tab.m2[0, 0]) == 0.0 and float(tab.m2[0, 3]) == 0.0
    assert torch.isfinite(torch.stack([tab.c_lat, tab.c_d, tab.m2])).all()
    g = torch.Generator().manual_seed(0)
    lat, eps = (torch.randn((2, 4, 4, 4), generator=g) for _ in range(2))
    hist = torch.randn((2, 1, 4, 4, 4), generator=g)
    pid, idx = torch.zeros(2, dtype=torch.int64), torch.full((2,), 3)
    new, new_hist = T.solver_update(lat, eps, hist, tab, bank, pid, idx)
    a_t = tab.a_t[0, 3]
    x0 = (lat - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    assert torch.equal(new, x0) and torch.equal(new_hist[:, 0], x0)


# ---------------------------------------------------------------------------
# The per-row solver update against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["uniform", "karras"])
def test_solver_update_matches_jax(schedule):
    """A bank of ddim, plms and dpm2m; six rows at staggered steps (two
    per policy), so one call mixes families and step indices.  The JAX
    side chains its latents and history through every step of every
    budget (steps 0-4 and each policy's last), on its jitted tables; the
    port takes the same inputs at each call, on those tables converted,
    so each call is held alone.  A wrong history order, PLMS weight row
    or dpm2m x0 mix moves a row far beyond 1e-6."""
    specs = ("ddim,steps=5", "plms,steps=6", "dpm2m,steps=5")
    bj = tuple(J.SamplerPolicy.parse(f"{s},schedule={schedule}")
               for s in specs)
    bt = tuple(T.SamplerPolicy.parse(f"{s},schedule={schedule}")
               for s in specs)
    tj = jax.jit(lambda: J.solver_tables(bj, JDDIM()))()
    tt = T.SolverTables(**{f: torch.from_numpy(
        np.asarray(getattr(tj, f)).copy()).to(
            torch.int64 if f in ("t", "solver", "budget") else None)
        for f in tj._fields})
    pid = np.array([0, 1, 2, 1, 2, 0])
    lag = np.array([0, 0, 0, 2, 1, 3])     # row r starts at call lag[r]
    budget = np.array([p.num_steps for p in bt])[pid]
    rng = np.random.default_rng(5)
    shape = (len(pid), 4, 4, 4)
    lat = rng.standard_normal(shape).astype(np.float32)
    hist_j = J.init_history(bj, len(pid), shape[1:])
    assert T.init_history(bt, len(pid), shape[1:]).shape == \
        hist_j.shape == (len(pid), 3) + shape[1:]
    lat_j = jnp.asarray(lat)
    update_j = jax.jit(lambda l, e, h, p, i: J.solver_update(
        l, e, h, tj, bj, p, i))
    seen = set()
    for call in range(int((lag + budget).max())):
        step = call - lag
        live = (step >= 0) & (step < budget)
        idx = np.clip(step, 0, budget - 1)
        seen |= {(int(p), int(i)) for p, i in zip(pid[live], idx[live])}
        eps = rng.standard_normal(shape).astype(np.float32)
        nj, hj = update_j(lat_j, jnp.asarray(eps), hist_j,
                          jnp.asarray(pid, jnp.int32),
                          jnp.asarray(idx, jnp.int32))
        nt, ht = T.solver_update(
            torch.from_numpy(np.array(lat_j)), torch.from_numpy(eps),
            torch.from_numpy(np.array(hist_j)), tt, bt,
            torch.from_numpy(pid), torch.from_numpy(idx))
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6,
                                   atol=1e-6, err_msg=f"latents, call {call}")
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                                   atol=1e-6, err_msg=f"history, call {call}")
        keep = live.reshape((-1,) + (1,) * (len(shape) - 1))
        lat_j = jnp.where(keep, nj, lat_j)
        hist_j = jnp.where(keep[:, None], hj, hist_j)
    assert seen == {(p, i) for p in range(3)
                    for i in range(bt[p].num_steps)}


# ---------------------------------------------------------------------------
# The banked ledger against the JAX package's, on the same buckets
# ---------------------------------------------------------------------------
def _synthetic_accum(cfg, bank, seed, empty_policy=None):
    """Integer buckets in the banked layout: rows per (policy, step),
    counters below each bucket's attainable maximum."""
    rng = np.random.default_rng(seed)
    layers = attn_layer_order(cfg.unet)
    n_max = T.bank_max_steps(bank)
    nb, nl = len(bank) * n_max, len(layers)
    rows = np.zeros(nb, np.int64)
    for p, pol in enumerate(bank):
        if p != empty_policy:
            rows[p * n_max:p * n_max + pol.num_steps] = rng.integers(1, 5)
    tq = np.array([lk.resolution ** 2 for lk in layers])
    cap = rows[:, None] * cfg.unet.num_heads * tq[None, :] ** 2
    nnz = (cap * rng.uniform(0.3, 1.0, (nb, nl))).astype(np.int64)
    xor = (nnz * rng.uniform(0.1, 0.9, (nb, nl))).astype(np.int64)
    imp = (rows[:, None] * tq[None, :]
           * rng.uniform(0.0, 1.0, (nb, nl))).astype(np.int64)
    zeros = np.zeros((nb, nl), np.int64)
    planes = dict(nnz=nnz, ones_xor=xor, imp=imp, rows=rows,
                  reuse_computed=zeros, reuse_total=zeros)
    return (JAccum(**{k: jnp.asarray(v, jnp.int32)
                      for k, v in planes.items()}),
            LedgerAccum(**{k: torch.from_numpy(v) for k, v in planes.items()}))


@pytest.mark.parametrize("seed,empty", [(0, None), (1, 1)])
def test_banked_ledger_matches_jax(seed, empty):
    specs = ("ddim,steps=3", "dpm2m,steps=4,phases=tips_scale=2:1:0.5",
             "plms,steps=2,name=fast")
    bj = tuple(J.SamplerPolicy.parse(s) for s in specs)
    bt = tuple(T.SamplerPolicy.parse(s) for s in specs)
    from repro.configs import bk_sdm as j_bk
    jcfg, tcfg = j_bk.SMOKE, t_bk.SMOKE
    aj, at = _synthetic_accum(tcfg, bt, seed, empty)
    assert (t_pipeline.energy_report_banked(tcfg, at, bt).summary()
            == j_pipeline.energy_report_banked(jcfg, aj, bj).summary())
    assert (t_pipeline.phase_breakdown_from_accum(tcfg, at, bt)
            == j_pipeline.phase_breakdown_from_accum(jcfg, aj, bj))
    # the legacy (single-schedule) layout: the config's 3 steps
    aj, at = _synthetic_accum(tcfg, (T.SamplerPolicy.ddim(3),), seed)
    assert (t_pipeline.energy_report_from_accum(tcfg, at).summary()
            == j_pipeline.energy_report_from_accum(jcfg, aj).summary())
    assert (t_pipeline.tips_ratios_from_accum(tcfg, at)
            == j_pipeline.tips_ratios_from_accum(jcfg, aj))


# ---------------------------------------------------------------------------
# Engine contracts on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def eng():
    cfg = t_bk.SMOKE
    cfg = dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))
    return DiffusionEngine(cfg, device="cpu", params=init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))


def _request(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.text.vocab_size,
                        (1, cfg.text.max_len)).astype(np.int32)
    toks[:, 0] = 0
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    return torch.from_numpy(toks), torch.from_numpy(lat)


@pytest.mark.parametrize("phases", [None, T.PhaseSchedule(
    boundaries=(0.3, 0.6), tips_on=(True, True, False))])
def test_single_policy_ddim_bank_matches_legacy(eng, phases):
    cfg = eng.cfg
    assert (cfg.ddim.num_inference_steps, cfg.ddim.tips_active_iters) == \
        (3, 2)
    toks, lat = _request(cfg, 1)
    toks, lat = torch.cat([toks, toks.flip(1)]), torch.cat([lat, -lat])
    un = torch.zeros_like(toks)
    legacy = eng.generate(toks, uncond_tokens=un, latents=lat)
    pol = T.SamplerPolicy.ddim(3, phases=phases)
    out = eng.generate(toks, uncond_tokens=un, latents=lat,
                       sampler_policy=pol)
    assert torch.equal(out.latents, legacy.latents)
    assert torch.equal(out.images, legacy.images)
    assert (t_pipeline.energy_report(cfg, out.stats,
                                     sampler_policy=pol).summary()
            == t_pipeline.energy_report(cfg, legacy.stats).summary())


def test_generate_rejects_policy_outside_bank(eng):
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="bank"):
        eng.generate(toks, uncond_tokens=toks,
                     sampler_policy=T.SamplerPolicy.ddim(3),
                     sampler_bank=(T.SamplerPolicy.dpm2m(2),))


def test_mixed_bank_slot_trace_bit_identical(eng):
    """ddim@3, dpm2m@4 with a TIPS-threshold schedule and plms@5 share two
    slots, admitted one per step; each request equals a one-shot run of
    its policy under the same bank, tiled to the slot batch."""
    cfg = eng.cfg
    bank = (T.SamplerPolicy.ddim(3), T.SamplerPolicy.dpm2m(
        4, phases=T.PhaseSchedule(tips_scale=(2.0, 1.0, 0.5))),
        T.SamplerPolicy.plms(5))
    policies = [1, 0, 2, 1]
    reqs = [_request(cfg, 10 + i) for i in range(len(policies))]
    state = eng.init_slots(2, bank=bank)
    queue, owner, final = list(range(len(reqs))), {}, {}
    while queue or owner:
        for s in range(2):
            if s not in owner and queue:
                r = queue.pop(0)
                state = eng.admit(state, s, reqs[r][0],
                                  uncond_tokens=torch.zeros_like(reqs[r][0]),
                                  latents=reqs[r][1],
                                  policy_index=policies[r])
                owner[s] = r
                break
        state = eng.slot_step(state)
        done = eng.finished_slots(state)
        for s in done:
            final[owner.pop(s)] = state.latents[s].clone()
        if done:
            state = eng.retire(state, done)
    for r, (toks, lat) in enumerate(reqs):
        pol = bank[policies[r]]
        out = eng.generate(toks.repeat(2, 1),
                           uncond_tokens=torch.zeros_like(toks).repeat(2, 1),
                           latents=lat.repeat(2, 1, 1, 1),
                           sampler_policy=pol, sampler_bank=bank)
        assert torch.equal(final[r], out.latents[0]), f"request {r}"
    n_max = T.bank_max_steps(bank)
    rows = state.accum.rows.tolist()
    for p, pol in enumerate(bank):
        seg = rows[p * n_max:(p + 1) * n_max]
        assert seg == [policies.count(p)] * pol.num_steps \
            + [0] * (n_max - pol.num_steps)


# ---------------------------------------------------------------------------
# Per-row PSSA thresholds take the reference route
# ---------------------------------------------------------------------------
def test_per_row_threshold_dispatch_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
               for _ in range(3))
    thr = np.array([1 / 64, 1 / 32], np.float32)
    jp = j_dispatch.KernelPolicy(self_attention="fused", interpret=True)
    oj = j_dispatch.self_attention(jp, *map(jnp.asarray, (q, k, v)),
                                   patch=16, threshold=jnp.asarray(thr),
                                   row_stats=True)
    rj = j_attention.self_attention_pssa(*map(jnp.asarray, (q, k, v)),
                                         patch=16, threshold=jnp.asarray(thr),
                                         row_stats=True)
    ot = t_dispatch.self_attention(KernelPolicy.fused(),
                                   *map(torch.from_numpy, (q, k, v)),
                                   patch=16, threshold=torch.from_numpy(thr),
                                   row_stats=True)
    for a, b in ((oj, rj), (oj, ot)):
        np.testing.assert_array_equal(np.asarray(b.stats.nnz),
                                      np.asarray(a.stats.nnz))
        np.testing.assert_array_equal(np.asarray(b.stats.ones_xor),
                                      np.asarray(a.stats.ones_xor))
        np.testing.assert_allclose(np.asarray(b.out), np.asarray(a.out),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("phases,fused_calls", [
    (T.PhaseSchedule(pssa_scale=(2.0, 1.0, 1.0)), 0),
    (T.PhaseSchedule(tips_scale=(2.0, 1.0, 1.0)), 9)])
def test_pssa_scale_bank_takes_reference_route(eng, monkeypatch, phases,
                                               fused_calls):
    cfg = dataclasses.replace(eng.cfg, unet=dataclasses.replace(
        eng.cfg.unet, kernel_policy=KernelPolicy.fused()))
    fe = DiffusionEngine(cfg, device="cpu", params={
        "text": eng.text_params, "unet": eng.unet_params,
        "vae": eng.vae_params})
    calls = {"fused": 0, "reference": 0}
    for name, key in (("self_attention_pssa_fused", "fused"),
                      ("self_attention_pssa", "reference")):
        orig = getattr(t_attention, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(t_attention, name, spy)
    bank = (T.SamplerPolicy.ddim(3, phases=phases),)
    state = fe.init_slots(2, bank=bank)
    toks, lat = _request(cfg, 3)
    state = fe.admit(state, 0, toks, uncond_tokens=torch.zeros_like(toks),
                     latents=lat)
    state = fe.slot_step(state)
    layers = len(attn_layer_order(cfg.unet))
    assert calls == {"fused": fused_calls,
                     "reference": layers - fused_calls}
    assert int(state.accum.rows.sum()) == 1
