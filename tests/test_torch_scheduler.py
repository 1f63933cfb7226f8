"""Port parity: the continuous and fixed-batch schedulers and the
``serve_diffusion`` front-end.

Port against JAX: the same numpy-made requests (all at t = 0) through the
JAX package's ``ContinuousScheduler`` / ``FixedBatchScheduler`` and the
port's, on the same weights (``repro_torch.convert``), at the same slot
count or micro-batch.  Tolerances are those of
``test_torch_slots.py::test_slot_drain_matches_jax``: images within 1e-4
on the reference route with TIPS off, within 2e-2 with TIPS on the
fused + DBSC route (a TIPS INT6 code flipped by an ulp of upstream
difference, ROADMAP Queue 3 item 3); the ``energy`` dicts, ``per_tier``
counts, ``engine_steps`` and ``mean_occupancy`` equal.

Port against itself, at knife-edge thresholds (PSSA 1/T, TIPS
1/text_len): continuous equals fixed batch bit for bit at equal batch
content, the headline is the same across slot counts, arrival gating,
FIFO admission past the slot count and a single-request trace; a
scheduler that skips ``retire`` fails the image check.  The port runs on
one intra-op thread (torch on the CPU is not batch-invariant with
several: ROADMAP Queue 3 item 14).
"""
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.diffusion.denoiser import make_denoiser
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.solvers import SamplerPolicy as JPolicy
from repro.kernels.dispatch import KernelPolicy as JKP
from repro.launch import scheduler as j_sched
from repro.launch import serve_diffusion as j_serve
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.solvers import SamplerPolicy
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.launch import scheduler as t_sched
from repro_torch.launch import serve_diffusion as t_serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAT_ATOL = {"reference": 1e-4, "fused_dbsc": 2e-2}
ROUTES = {
    "reference": (JKP(), TKP()),
    "fused_dbsc": (JKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc", interpret=True),
                   TKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc")),
}
TIERS = ("ddim,steps=3", "dpm2m,steps=4")


def _guided(bk, policy, tips=True):
    cfg = bk.with_kernel_policy(bk.SMOKE, policy)
    cfg = dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))
    if not tips:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, tips=False))
    return cfg


def _knife_edge(cfg):
    """PSSA threshold 1/T and TIPS threshold 1/text_len: every counter
    moves with its input."""
    t = cfg.unet.latent_size ** 2
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, pssa_threshold=1.0 / t,
        precision=PrecisionPolicy(threshold=1.0 / cfg.unet.text_len)))


def _arrays(cfg, n, seed=7):
    """(tokens, uncond tokens, latents) numpy triples, one per request."""
    rng = np.random.default_rng(seed)
    s, ln = cfg.unet.latent_size, cfg.text.max_len
    out = []
    for _ in range(n):
        toks = rng.integers(1, cfg.text.vocab_size, (1, ln)).astype(np.int32)
        toks[:, 0] = 0
        lat = rng.standard_normal((1, s, s, 4)).astype(np.float32)
        out.append((toks, np.zeros_like(toks), lat))
    return out


def _t_requests(arrays, bank=None):
    return [t_sched.Request(
        rid=i, tokens=torch.from_numpy(tk), arrival_s=0.0,
        latents=torch.from_numpy(lat), uncond_tokens=torch.from_numpy(un),
        policy_index=i % len(bank) if bank else 0,
        tier=bank[i % len(bank)].label() if bank else "")
        for i, (tk, un, lat) in enumerate(arrays)]


def _j_requests(arrays, bank=None):
    return [j_sched.Request(
        rid=i, tokens=jnp.asarray(tk), arrival_s=0.0,
        latents=jnp.asarray(lat), uncond_tokens=jnp.asarray(un),
        policy_index=i % len(bank) if bank else 0,
        tier=bank[i % len(bank)].label() if bank else "")
        for i, (tk, un, lat) in enumerate(arrays)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_engine():
    """One JAX engine (its random init is the slow part) and its weights
    converted for the port."""
    je = JEngine(_guided(j_bk, JKP()), key=jax.random.PRNGKey(0))
    params = convert_params(*jax.device_get(
        (je.text_params, je.unet_params, je.vae_params)))
    return je, params


def _j_on(je, cfg):
    """The module's JAX engine, weights shared, on another config."""
    other = copy.copy(je)
    other.cfg = cfg
    other.denoiser = make_denoiser(cfg.unet)
    other._compiled, other._slot_compiled = {}, {}
    other._encode_fn = other._decode_fn = other._admit_fn = None
    return other


def _strip(m):
    m.pop("state", None)
    return m


# ---------------------------------------------------------------------------
# Port against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched,route,tips,tiers", [
    ("continuous", "reference", False, False),
    ("continuous", "fused_dbsc", True, False),
    ("continuous", "reference", False, True),
    ("fixed", "reference", False, False),
    ("fixed", "fused_dbsc", True, False)])
def test_scheduler_matches_jax(jax_engine, sched, route, tips, tiers):
    jpol, tpol = ROUTES[route]
    je, params = jax_engine
    jcfg, tcfg = _guided(j_bk, jpol, tips), _guided(t_bk, tpol, tips)
    je = _j_on(je, jcfg)
    te = TEngine(tcfg, device="cpu", params=params)
    arrays = _arrays(tcfg, 3)
    jbank = tuple(JPolicy.parse(t) for t in TIERS) if tiers else None
    tbank = tuple(SamplerPolicy.parse(t) for t in TIERS) if tiers else None
    jreqs, treqs = _j_requests(arrays, jbank), _t_requests(arrays, tbank)
    if sched == "continuous":
        mj = _strip(j_sched.ContinuousScheduler(je, 2, bank=jbank)
                    .run(jreqs, ledger=True))
        mt = _strip(t_sched.ContinuousScheduler(te, 2, bank=tbank)
                    .run(treqs, ledger=True))
        for k in ("engine_steps", "mean_occupancy", "num_slots"):
            assert mt[k] == mj[k], k
    else:
        mj = j_sched.FixedBatchScheduler(je, 2).run(jreqs, ledger=True)
        mt = t_sched.FixedBatchScheduler(te, 2).run(treqs, ledger=True)
        assert mt["engine_calls"] == mj["engine_calls"] == 2
    for rj, rt in zip(jreqs, treqs):
        assert rt.image.shape == (128, 128, 3)
        np.testing.assert_allclose(rt.image, np.asarray(rj.image), rtol=0,
                                   atol=LAT_ATOL[route],
                                   err_msg=f"request {rt.rid}")
    assert set(mt) == set(mj)
    assert mt["energy"] == jax.tree_util.tree_map(
        lambda x: x.item() if hasattr(x, "item") else x, mj["energy"])
    if tiers:
        assert {t: v["requests"] for t, v in mt["per_tier"].items()} == \
            {t: v["requests"] for t, v in mj["per_tier"].items()}
        assert mt["bank"] == mj["bank"]
    else:
        assert mt["tips_low_ratio_per_iter"] == \
            mj["tips_low_ratio_per_iter"]
        assert mt["tips_workload_low_fraction"] == \
            mj["tips_workload_low_fraction"]


# ---------------------------------------------------------------------------
# Port against itself, knife-edge thresholds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knife(jax_engine):
    cfg = _knife_edge(_guided(t_bk, ROUTES["fused_dbsc"][1]))
    return cfg, TEngine(cfg, device="cpu", params=jax_engine[1])


def _images(reqs):
    return {r.rid: r.image for r in reqs}


def test_continuous_equals_fixed_batch_bit_for_bit(knife):
    """Four requests at t = 0, 2 slots against micro-batches of 2: each
    slot batch holds the same two requests as one micro-batch, so even
    the DBSC FFN's one shared scale is equal; images, the energy dict and
    the TIPS ratios equal bit for bit."""
    cfg, eng = knife
    arrays = _arrays(cfg, 4)
    rc, rf = _t_requests(arrays), _t_requests(arrays)
    mc = _strip(t_sched.ContinuousScheduler(eng, 2).run(rc, ledger=True))
    mf = t_sched.FixedBatchScheduler(eng, 2).run(rf, ledger=True)
    for a, b in zip(rc, rf):
        assert a.image.tobytes() == b.image.tobytes(), f"request {a.rid}"
    assert mc["energy"] == mf["energy"]
    assert mc["tips_low_ratio_per_iter"] == mf["tips_low_ratio_per_iter"]
    assert 0.0 < mc["tips_workload_low_fraction"] < 1.0
    assert mc["engine_steps"] == 2 * cfg.ddim.num_inference_steps
    assert mc["mean_occupancy"] == 1.0
    assert mc["latency_s"]["p95"] > 0 and mf["latency_s"]["p95"] > 0


def test_headline_is_the_same_across_slot_counts(knife):
    """The integer accumulator: 2 and 4 slots, one-shot in batches of 2,
    one headline (reference route: no row shares a quantizer scale)."""
    cfg = dataclasses.replace(knife[0], unet=dataclasses.replace(
        knife[0].unet, kernel_policy=TKP()))
    eng = TEngine(cfg, device="cpu", params={
        "text": knife[1].text_params, "unet": knife[1].unet_params,
        "vae": knife[1].vae_params})
    arrays = _arrays(cfg, 4, seed=11)
    energy = [_strip(t_sched.ContinuousScheduler(eng, s).run(
        _t_requests(arrays), ledger=True))["energy"] for s in (2, 4)]
    fixed = t_sched.FixedBatchScheduler(eng, 2).run(_t_requests(arrays),
                                                    ledger=True)["energy"]
    assert energy[0] == energy[1] == fixed


def test_arrival_gating_and_poisson_trace(knife):
    cfg, eng = knife
    reqs = _t_requests(_arrays(cfg, 3))
    t_sched.apply_trace(reqs, [0.0, 0.0, 0.35])
    m = _strip(t_sched.ContinuousScheduler(eng, 2).run(reqs))
    late = reqs[2]
    assert late.admitted_s >= 0.35
    assert late.finished_s > late.admitted_s
    assert all(r.image is not None for r in reqs)
    assert m["queue_wait_s"]["p95"] >= 0.0
    reqs = _t_requests(_arrays(cfg, 3))
    t_sched.apply_trace(reqs, t_sched.poisson_trace(3, 20.0, seed=1))
    t_sched.FixedBatchScheduler(eng, 2).run(reqs)
    for r in reqs:
        assert r.admitted_s >= r.arrival_s and r.image is not None


def test_burst_larger_than_slot_count_is_fifo(knife):
    """A burst of 5 into 2 slots: the overflow queues and enters freed
    slots in arrival order; the first pair equals one-shot at batch 2."""
    cfg, eng = knife
    arrays = _arrays(cfg, 5, seed=5)
    reqs = _t_requests(arrays)
    t_sched.apply_trace(reqs, t_sched.bursty_trace(5, burst=5, gap_s=0.0))
    m = _strip(t_sched.ContinuousScheduler(eng, 2).run(reqs))
    admits = [r.admitted_s for r in reqs]
    assert admits == sorted(admits)
    # pairs (r0, r1), (r2, r3), then r4 alone: 3 x 3 steps
    assert m["engine_steps"] == 3 * cfg.ddim.num_inference_steps
    assert m["mean_occupancy"] == 5 / 6
    one = eng.generate(torch.from_numpy(np.concatenate(
        [a[0] for a in arrays[:2]])), uncond_tokens=torch.from_numpy(
        np.concatenate([a[1] for a in arrays[:2]])),
        latents=torch.from_numpy(np.concatenate([a[2] for a in arrays[:2]])))
    for i in (0, 1):
        assert reqs[i].image.tobytes() == one.images[i].numpy().tobytes()


def test_single_request_trace(knife):
    cfg, eng = knife
    reqs = _t_requests(_arrays(cfg, 1))
    m = _strip(t_sched.ContinuousScheduler(eng, 4).run(reqs, ledger=True))
    assert m["requests"] == 1
    lat = m["latency_s"]
    assert lat["p50"] == lat["p95"] == lat["max"] == lat["mean"] > 0
    assert m["engine_steps"] == cfg.ddim.num_inference_steps
    assert m["mean_occupancy"] == 0.25
    assert np.isfinite(reqs[0].image).all()
    assert np.isfinite(m["energy"]["mj_per_iter_with_ema"])


def test_skipping_retire_fails_the_image_check(knife, monkeypatch):
    """Positive control.  Three requests at t = 0 on 2 slots: request 2
    runs beside an idle row.  A scheduler that skips ``retire`` leaves
    that row active, so it keeps stepping beside request 2 and (DBSC
    quantizes on one scale over the batch) moves request 2's image.
    ``finished_slots`` is narrowed to rows finishing this step so that
    the broken run completes (else it reports the stale row again)."""
    cfg, eng = knife
    arrays = _arrays(cfg, 3)
    good = _t_requests(arrays)
    _strip(t_sched.ContinuousScheduler(eng, 2).run(good))
    n = cfg.ddim.num_inference_steps
    finished = eng.finished_slots
    monkeypatch.setattr(eng, "retire", lambda state, slots: state)
    monkeypatch.setattr(eng, "finished_slots", lambda state: [
        s for s in finished(state) if int(state.step_idx[s]) == n])
    bad = _t_requests(arrays)
    _strip(t_sched.ContinuousScheduler(eng, 2).run(bad))
    same = [g.image.tobytes() == b.image.tobytes()
            for g, b in zip(good, bad)]
    assert same == [True, True, False]


# ---------------------------------------------------------------------------
# The serve_diffusion front-end
# ---------------------------------------------------------------------------
def _smoke(bk, policy, steps=2):
    cfg = _guided(bk, policy)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, num_inference_steps=steps, tips_active_iters=1))


def test_serve_metric_keys_match_jax():
    jcfg, tcfg = _smoke(j_bk, JKP()), _smoke(t_bk, TKP())
    mj = j_serve.serve(jcfg, j_serve.synthetic_requests(jcfg, 3), 2,
                       ledger=True)
    mt = t_serve.serve(tcfg, t_serve.synthetic_requests(tcfg, 3,
                                                        device="cpu"),
                       2, ledger=True, device="cpu")
    assert set(mt) == set(mj)
    assert mt["mesh"] is None
    assert mt["engine_calls"] == 2 and mt["padded_rows"] == 1
    assert mt["kernel_policy"]["backend"] == "cpu"
    pol = SamplerPolicy.parse("dpm2m,steps=3")
    mt = t_serve.serve(tcfg, t_serve.synthetic_requests(tcfg, 2,
                                                        device="cpu"),
                       2, ledger=True, sampler_policy=pol, device="cpu")
    assert mt["steps_per_image"] == 3 and "sampler_policy" in mt
    assert "tips_low_ratio_per_iter" not in mt


@pytest.mark.parametrize("kw", [{}, {"tiers": True, "arrival_rate": 50.0,
                                     "burst": 2}])
def test_serve_continuous_metric_keys_match_jax(kw):
    jcfg, tcfg = _smoke(j_bk, JKP()), _smoke(t_bk, TKP())
    tiers = kw.pop("tiers", False)
    jbank = tuple(JPolicy.parse(t) for t in TIERS) if tiers else None
    tbank = tuple(SamplerPolicy.parse(t) for t in TIERS) if tiers else None
    mj = j_serve.serve_continuous(jcfg, 3, 2, ledger=True, bank=jbank, **kw)
    mt = t_serve.serve_continuous(tcfg, 3, 2, ledger=True, bank=tbank,
                                  device="cpu", **kw)
    assert set(mt) == set(mj)
    assert mt["requests"] == 3 and mt["engine_steps"] == mj["engine_steps"]
    assert mt["workload"] == mj["workload"]
    if tiers:
        assert set(mt["per_tier"]) == set(mj["per_tier"])


def test_make_requests_do_not_depend_on_n():
    cfg = t_bk.SMOKE
    a = t_sched.make_requests(cfg, 2, seed=3, device="cpu")
    b = t_sched.make_requests(cfg, 5, seed=3, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x.tokens, y.tokens)
        assert torch.equal(x.latents, y.latents)
    assert not torch.equal(a[0].latents, a[1].latents)
    e = t_sched.make_edit_requests(cfg, 3, seed=3, device="cpu")
    outside = torch.ones_like(e[0].latents, dtype=torch.bool)
    for r in e[:2]:
        y0, x0, h, w = r.edit_window
        assert h == w == 4
        outside[:, y0:y0 + h, x0:x0 + w] = False
    assert torch.equal(e[0].latents[outside], e[1].latents[outside])
    assert not torch.equal(e[0].latents, e[1].latents)


@pytest.mark.parametrize("argv", [
    ["--continuous", "--slots", "2", "--requests", "3", "--ledger",
     "--edit", "--reuse", "temporal"],
    ["--model", "dit", "--requests", "2", "--micro-batch", "2",
     "--ledger"]])
def test_main_on_the_cpu(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_diffusion",
         "--smoke", "--device", "cpu", "--steps", "2", "--guidance", "7.5"]
        + argv, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    head, _, body = out.stdout.partition("\n")
    assert head.startswith("engine: model ") and "device cpu" in head
    m = json.loads(body)
    assert m["kernel_policy"]["backend"] == "cpu"
    assert m["kernel_policy"]["self_attention"] == "reference"
    assert np.isfinite(m["energy"]["mj_per_iter_with_ema"])
    assert m["denoiser_family"] == ("dit" if "dit" in argv else "unet")
    if "--edit" in argv:
        assert m["workload"] == "edit" and m["reuse_policy"]["enabled"]
        assert len(m["reuse_ratio_per_iter"]) == 2
