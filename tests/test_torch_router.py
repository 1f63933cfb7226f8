"""Port parity: the cluster router (``launch.router``), the merged ledger
(``pipeline.merge_ledger_accums`` / ``energy_report_cluster``) and
``serve_diffusion.serve_cluster``.

Port against JAX: the same numpy-made requests (all at t = 0) through the
JAX package's ``ClusterRouter`` and the port's, on the same weights
(``repro_torch.convert``).  The routing (every ``admitted`` event),
``finish_round``, ``rounds``, ``engine_steps``, ``mean_occupancy`` and the
``energy`` dicts are equal; images within 1e-4 on the reference route
with TIPS off and within 2e-2 on the fused + DBSC route with TIPS
(``test_torch_scheduler.py``'s tolerances); the overload example of the
JAX package's ``tests/test_router.py`` round for round.

Port against itself, on the reference route (float FFN) at knife-edge
thresholds (PSSA 1/T, TIPS 1/text_len): 1, 2 and 3 replicas give the same
images, int64 buckets and headline, equal to one-shot ``generate`` at
batch 2; a headline from one replica's accumulator alone differs (the
positive control).  The port runs on one intra-op thread (ROADMAP Queue 3
item 14).
"""
import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.solvers import SamplerPolicy as JPolicy
from repro.kernels.dispatch import KernelPolicy as JKP
from repro.launch import router as j_router
from repro.launch import scheduler as j_sched
from repro.launch import serve_diffusion as j_serve
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import (energy_report_cluster,
                                            energy_report_multi,
                                            merge_ledger_accums)
from repro_torch.diffusion.solvers import SamplerPolicy
from repro_torch.diffusion.stats import LedgerAccum
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.launch import router as t_router
from repro_torch.launch import scheduler as t_sched
from repro_torch.launch import serve_diffusion as t_serve
from test_torch_scheduler import (LAT_ATOL, ROUTES, _arrays, _guided, _j_on,
                                  _knife_edge)

BANK = ("ddim,steps=4", "ddim,steps=2")
PLANES = [f.name for f in dataclasses.fields(LedgerAccum)]


def _requests(mod, to, arrays, bank=None, tier0=False):
    """``mod.Request``s of ``arrays``; ``tier0``: every request at the
    bank's first tier, else round-robin over the bank."""
    reqs = []
    for i, (tk, un, lat) in enumerate(arrays):
        p = 0 if tier0 or not bank else i % len(bank)
        reqs.append(mod.Request(
            rid=i, tokens=to(tk), arrival_s=0.0, latents=to(lat),
            uncond_tokens=to(un), policy_index=p,
            tier=bank[p].label() if bank else ""))
    return reqs


def _t_requests(arrays, bank=None, tier0=False):
    return _requests(t_sched, torch.from_numpy, arrays, bank, tier0)


def _j_requests(arrays, bank=None, tier0=False):
    return _requests(j_sched, jnp.asarray, arrays, bank, tier0)


def _run(router, reqs, ledger=True):
    """``router.run`` with every event it streamed."""
    events, stream = [], router.stream

    def recording(r):
        for ev in stream(r):
            events.append(ev)
            yield ev
    router.stream = recording
    m = router.run(reqs, ledger=ledger)
    return m, events


def _admitted(events):
    return [(ev["rid"], ev["replica"], ev["slot"], ev["round"], ev["tier"],
             ev["degraded_from"]) for ev in events
            if ev["event"] == "admitted"]


def _plain(tree):
    return jax.tree_util.tree_map(
        lambda x: x.item() if hasattr(x, "item") else x, tree)


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


# ---------------------------------------------------------------------------
# Port against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route,tips", [("reference", False),
                                        ("fused_dbsc", True)])
def test_router_matches_jax(jax_engine, route, tips):
    """(a) 2 replicas x 2 slots, six requests at t = 0."""
    jpol, tpol = ROUTES[route]
    je, params = jax_engine
    je = _j_on(je, _guided(j_bk, jpol, tips))
    te = TEngine(_guided(t_bk, tpol, tips), device="cpu", params=params)
    arrays = _arrays(te.cfg, 6)
    jreqs, treqs = _j_requests(arrays), _t_requests(arrays)
    mj, ej = _run(j_router.ClusterRouter(je, 2, 2), jreqs)
    mt, et = _run(t_router.ClusterRouter(te, 2, 2), treqs)
    mj.pop("states"), mt.pop("states")
    assert _admitted(et) == _admitted(ej)
    assert [ev[1] for ev in _admitted(et)][:4] == [0, 1, 0, 1]
    assert [r.finish_round for r in treqs] == \
        [r.finish_round for r in jreqs]
    for k in ("rounds", "engine_steps", "mean_occupancy", "events",
              "dropped"):
        assert mt[k] == mj[k], k
    assert mt["rounds"] == 2 * te.cfg.ddim.num_inference_steps
    assert set(mt) == set(mj)
    assert mt["energy"] == _plain(mj["energy"])
    for rj, rt in zip(jreqs, treqs):
        assert rt.image.shape == (128, 128, 3)
        np.testing.assert_allclose(rt.image, np.asarray(rj.image), rtol=0,
                                   atol=LAT_ATOL[route],
                                   err_msg=f"request {rt.rid}")


def test_overload_matches_jax(jax_engine):
    """(b) The worked overload example: bank ddim@4 / ddim@2, six
    requests at tier 0, a deadline of 6 rounds, one replica of 2 slots;
    degrading, then queueing, round for round against the JAX router."""
    je, params = jax_engine
    jcfg = _guided(j_bk, JKP(), tips=False)
    tcfg = _guided(t_bk, TKP(), tips=False)
    je = _j_on(je, jcfg)
    te = TEngine(tcfg, device="cpu", params=params)
    jbank = tuple(JPolicy.parse(b) for b in BANK)
    tbank = tuple(SamplerPolicy.parse(b) for b in BANK)
    arrays = _arrays(tcfg, 6, seed=3)
    want = {True: ([4, 4, 6, 6, 8, 8], 4), False: ([4, 4, 8, 8, 12, 12], 2)}
    for degrade in (True, False):
        jreqs = _j_requests(arrays, jbank, tier0=True)
        treqs = _t_requests(arrays, tbank, tier0=True)
        mj, ej = _run(j_router.ClusterRouter(
            je, 1, 2, bank=jbank, slo=j_router.RouterSLO(6, degrade)), jreqs)
        mt, et = _run(t_router.ClusterRouter(
            te, 1, 2, bank=tbank, slo=t_router.RouterSLO(6, degrade)), treqs)
        waits = [r.finish_round - r.arrival_round for r in treqs]
        assert waits == [r.finish_round - r.arrival_round for r in jreqs]
        assert sorted(waits) == want[degrade][0]
        assert mt["slo"] == mj["slo"]
        assert mt["slo"]["met"] == want[degrade][1]
        assert _admitted(et) == _admitted(ej)
        assert mt.get("degraded_per_tier") == mj.get("degraded_per_tier")
        assert mt["energy"] == _plain(mj["energy"])
        per_policy = [e["images"] for e in mt["energy"]["per_policy"]]
        if degrade:
            assert mt["degraded_per_tier"] == {tbank[0].label(): 4}
            assert per_policy == [2, 4]
        else:
            assert "degraded_per_tier" not in mt and per_policy == [6, 0]
        assert [r.rid for r in sorted(treqs, key=lambda r: r.admitted_s)] \
            == [r.rid for r in treqs]
        for rj, rt in zip(jreqs, treqs):
            assert rt.tier == rj.tier and rt.degraded_from == rj.degraded_from
            np.testing.assert_allclose(rt.image, np.asarray(rj.image),
                                       rtol=0, atol=LAT_ATOL["reference"])


# ---------------------------------------------------------------------------
# Port against itself, knife-edge thresholds, reference route
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knife(jax_engine):
    cfg = _knife_edge(_guided(t_bk, TKP()))
    return cfg, TEngine(cfg, device="cpu", params=jax_engine[1])


@pytest.fixture(scope="module")
def by_replicas(knife):
    """Six requests at t = 0 through 1, 2 and 3 replicas x 2 slots."""
    cfg, eng = knife
    arrays = _arrays(cfg, 6, seed=11)
    out = {}
    for n in (1, 2, 3):
        reqs = _t_requests(arrays)
        m, events = _run(t_router.ClusterRouter(eng, n, 2), reqs)
        out[n] = (m, reqs, events)
    return arrays, out


def test_images_and_headline_equal_across_replica_counts(by_replicas):
    """(c) Bit-equal images, merged int64 buckets and energy at 1, 2 and
    3 replicas (each pairs other requests in a replica)."""
    _, runs = by_replicas
    m1, reqs1, _ = runs[1]
    merged1 = merge_ledger_accums(st.accum for st in m1["states"])
    assert int(merged1.nnz.sum()) > 0 and int(merged1.imp.sum()) > 0
    pairs = {}
    for n, (m, reqs, events) in runs.items():
        assert m["dropped"] == 0 and m["replicas"] == n
        for a, b in zip(reqs1, reqs):
            assert a.image.tobytes() == b.image.tobytes(), (n, a.rid)
        merged = merge_ledger_accums(st.accum for st in m["states"])
        for f in PLANES:
            assert torch.equal(getattr(merged, f), getattr(merged1, f)), \
                (n, f)
        assert m["energy"] == m1["energy"], n
        pairs[n] = sorted({(ev["replica"], ev["round"]) for ev in events
                           if ev["event"] == "admitted"})
    assert runs[3][0]["rounds"] == 3 and runs[1][0]["rounds"] == 9
    assert pairs[1] != pairs[3]


def test_router_equals_one_shot_generate(knife, by_replicas):
    """(d) The same requests through ``generate`` at batch 2: the same
    images bit for bit and ``energy_report_multi`` equal to the router's
    energy key for key."""
    cfg, eng = knife
    arrays, runs = by_replicas
    m1, reqs1, _ = runs[1]
    stats = []
    for i in range(0, 6, 2):
        chunk = arrays[i:i + 2]
        out = eng.generate(
            torch.from_numpy(np.concatenate([a[0] for a in chunk])),
            uncond_tokens=torch.from_numpy(
                np.concatenate([a[1] for a in chunk])),
            latents=torch.from_numpy(np.concatenate([a[2] for a in chunk])))
        for j in range(2):
            assert out.images[j].numpy().tobytes() == \
                reqs1[i + j].image.tobytes(), i + j
        stats.append(out.stats)
    rep = energy_report_multi(cfg, stats)
    assert m1["energy"] == {k: float(v) for k, v in rep.summary().items()}


def test_one_replica_headline_is_a_positive_control(knife, by_replicas):
    """(i) Replica 0's accumulator alone (a lost replica) gives another
    headline: the equality of (c) can fail."""
    cfg, _ = knife
    _, runs = by_replicas
    m2 = runs[2][0]
    lone = energy_report_cluster(cfg, [m2["states"][0].accum])
    lone = {k: float(v) for k, v in lone.summary().items()}
    assert lone != runs[1][0]["energy"]
    both = energy_report_cluster(cfg, [st.accum for st in m2["states"]])
    assert {k: float(v) for k, v in both.summary().items()} == \
        runs[1][0]["energy"]


def test_fifo_admission_into_least_occupied_replica(knife):
    """(e) Admission follows arrival order; the first wave alternates
    replicas."""
    cfg, eng = knife
    reqs = _t_requests(_arrays(cfg, 6, seed=5))
    admitted = [ev for ev in t_router.ClusterRouter(eng, 2, 2).stream(reqs)
                if ev["event"] == "admitted"]
    assert [ev["rid"] for ev in admitted] == [r.rid for r in reqs]
    assert [ev["replica"] for ev in admitted[:4]] == [0, 1, 0, 1]
    assert all(r.replica is not None for r in reqs)


@pytest.mark.parametrize("replicas", [1, 2])
def test_streaming_previews(knife, replicas):
    """(f) Previews every round: each request previews mid-flight, before
    it finishes, at the steps it has taken since admission, and its
    events run from ``admitted`` to ``finished``."""
    cfg, eng = knife
    router = t_router.ClusterRouter(eng, replicas, 2, preview_every=1)
    reqs = _t_requests(_arrays(cfg, 3, seed=3))
    events = list(router.stream(reqs))
    admitted_at = {ev["rid"]: ev["round"] for ev in events
                   if ev["event"] == "admitted"}
    previews = [ev for ev in events if ev["event"] == "preview"]
    assert previews and sum(r.previews for r in reqs) == len(previews)
    n = cfg.ddim.num_inference_steps
    for r in reqs:
        assert r.previews >= 1
        assert r.first_preview_s is not None
        assert r.first_preview_s <= r.finished_s
        kinds = [ev["event"] for ev in events if ev["rid"] == r.rid]
        assert kinds[0] == "admitted" and kinds[-1] == "finished"
        assert kinds.count("admitted") == kinds.count("finished") == 1
    for ev in previews:
        assert ev["image"].shape == reqs[0].image.shape
        assert 0 < ev["step"] < n
        assert ev["step"] == ev["round"] - admitted_at[ev["rid"]]
    m = t_router.ClusterRouter(eng, replicas, 2, preview_every=2).run(
        _t_requests(_arrays(cfg, 2, seed=3)))
    assert m["preview"]["every"] == 2 and m["preview"]["decodes"] == 2
    assert m["preview"]["first_preview_s"]["max"] > 0


def test_merge_ledger_accums_sums_and_guards():
    """(g) Every plane summed, in either order; the guards; int64 past
    2^31 stays exact."""
    a = LedgerAccum.zeros(3, 4)
    b = dataclasses.replace(a, nnz=a.nnz + 2, rows=a.rows + 1,
                            reuse_computed=a.reuse_computed + 3)
    c = dataclasses.replace(a, nnz=a.nnz + 5, reuse_total=a.reuse_total + 7,
                            ones_xor=a.ones_xor + 1, imp=a.imp + 4)
    merged = merge_ledger_accums([b, c])
    want = {"nnz": 7, "ones_xor": 1, "imp": 4, "rows": 1,
            "reuse_computed": 3, "reuse_total": 7}
    assert set(want) == set(PLANES)
    for f, v in want.items():
        assert (getattr(merged, f) == v).all(), f
        assert getattr(merged, f).dtype == torch.int64
    swapped = merge_ledger_accums(iter([c, b]))
    for f in PLANES:
        assert torch.equal(getattr(merged, f), getattr(swapped, f)), f
    assert merge_ledger_accums([b]) is not None
    big = dataclasses.replace(a, nnz=a.nnz + (2 ** 31 - 1))
    one = dataclasses.replace(a, nnz=a.nnz + 1)
    assert (merge_ledger_accums([big, one]).nnz == 2 ** 31).all()
    with pytest.raises(ValueError, match="no accumulators"):
        merge_ledger_accums([])
    with pytest.raises(ValueError, match="mismatched bucket layouts"):
        merge_ledger_accums([a, LedgerAccum.zeros(2, 4)])


def test_router_guards(knife):
    """(h) The JAX router's guards."""
    cfg, eng = knife
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        t_router.ClusterRouter(eng, 0, 2)
    with pytest.raises(ValueError, match="needs a sampler bank"):
        t_router.ClusterRouter(eng, 1, 2,
                               slo=t_router.RouterSLO(deadline_steps=4))
    router = t_router.ClusterRouter(eng, 1, 2)
    reqs = _t_requests(_arrays(cfg, 2, seed=5))
    reqs[1].policy_index = 1
    with pytest.raises(ValueError, match="policy_index"):
        list(router.stream(reqs))
    # a queueing SLO needs no bank
    assert t_router.ClusterRouter(
        eng, 1, 2, slo=t_router.RouterSLO(4, degrade=False)).bank is None


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _smoke(bk, policy, steps=2):
    cfg = _guided(bk, policy)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, num_inference_steps=steps, tips_active_iters=1))


def test_serve_cluster_metric_keys_match_jax():
    """(j) Tiers, an SLO and previews, so every optional key shows."""
    jcfg, tcfg = _smoke(j_bk, JKP()), _smoke(t_bk, TKP())
    tiers = ("ddim,steps=2", "ddim,steps=1")
    kw = dict(ledger=True, slo_steps=2, preview_every=1)
    mj = j_serve.serve_cluster(jcfg, 5, 2, 1, bank=tuple(
        JPolicy.parse(t) for t in tiers), **kw)
    mt = t_serve.serve_cluster(tcfg, 5, 2, 1, bank=tuple(
        SamplerPolicy.parse(t) for t in tiers), device="cpu", **kw)
    assert set(mt) == set(mj)
    assert "slo" in mt and "preview" in mt and "degraded_per_tier" in mt
    for k in ("rounds", "engine_steps", "slo", "degraded_per_tier",
              "steps_per_image", "workload"):
        assert mt[k] == mj[k], k
    assert set(mt["energy"]) == set(mj["energy"])
    assert mt["kernel_policy"]["backend"] == "cpu"


@pytest.mark.parametrize("kw", [{"steps": 3}, {"steps": 1},
                                {"steps": 25}])
def test_config_from_args_keywords_match_jax(kw):
    """``config_from_args(steps=)`` (the router's ``_main`` passes it)
    overrides the namespace as the JAX wiring does."""
    from repro.launch import cli as j_cli
    from repro_torch.launch import cli as t_cli
    from test_torch_policies import _namespace, _same_config
    argv = ["--smoke", "--steps", "5", "--guidance", "1.0"]
    tns, jns = _namespace(t_cli, argv, True), _namespace(j_cli, argv, False)
    cfg = t_cli.config_from_args(tns, **kw)
    _same_config(cfg, j_cli.config_from_args(jns, **kw))
    assert cfg.ddim.num_inference_steps == kw.get("steps", 5)
    assert cfg.ddim.guidance_scale == 1.0


ROUTER_GUARDS = [
    ["--replicas", "-1"],
    ["--replicas", "2", "--edit", "--continuous"],
    ["--replicas", "2", "--continuous"],
    ["--slo-steps", "4"],
    ["--replicas", "2", "--slo-steps", "4"],
    ["--preview-every", "2"],
    ["--tiers", "draft", "balanced"],
]


def _cli_error(run):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        run()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", ROUTER_GUARDS)
def test_cli_router_guards_match_jax(argv, monkeypatch):
    """(k) Each router guard of ``serve_diffusion`` refuses, in the JAX
    package's words (the port runs no scan executable: its ``--tiers``
    guard says "schedule", as before ``--replicas``)."""
    monkeypatch.setattr(sys, "argv", ["serve_diffusion", "--smoke"] + argv)
    want = _cli_error(j_serve.main).replace("one scan executable",
                                            "one schedule")
    got = _cli_error(lambda: t_serve.main(["--smoke", "--device", "cpu"]
                                          + argv))
    assert got == want


def test_router_main_checks_identity_in_process(capsys):
    """(l) The router's entry point on the CPU: 1 against 2 replicas,
    previews and the SLO off."""
    assert t_router._main(["--device", "cpu", "--check-identity",
                           "--requests", "4", "--steps", "2",
                           "--preview-every", "1"]) == 0
    m = json.loads(capsys.readouterr().out)
    assert m["ledger_bit_identical_across_replicas"] is True
    assert m["images_bit_identical_across_replicas"] is True
    assert m["mode"] == "cluster_router" and m["replicas"] == 2
    assert m["dropped"] == 0 and m["preview"]["decodes"] > 0
    assert m["policies"]["kernels"]["backend"] == "cpu"


def test_serve_diffusion_main_replicas_in_process(capsys):
    """(l) ``serve_diffusion --replicas 2`` on the CPU with the ledger."""
    t_serve.main(["--smoke", "--replicas", "2", "--slots", "2",
                  "--requests", "3", "--steps", "2", "--guidance", "7.5",
                  "--device", "cpu", "--ledger", "--solver",
                  "ddim,steps=2"])
    head, _, body = capsys.readouterr().out.partition("\n")
    assert head.startswith("engine: model ") and "router replicas=2" in head
    m = json.loads(body)
    assert m["mode"] == "cluster_router" and m["requests"] == 3
    assert m["kernel_policy"]["backend"] == "cpu"
    assert m["steps_per_image"] == [2]
    assert m["energy"]["images"] == 3
    assert np.isfinite(m["energy"]["per_policy"][0]["mj_per_iter_with_ema"])
