"""Port parity: the slot runtime (continuous batching, DESIGN.md §8).

Covers ``DiffusionEngine.init_slots / admit / slot_step / finished_slots /
decode_slots / decode_preview / retire``, ``SlotStats`` and
``LedgerAccum``, the per-row ``denoise_step`` and
``pipeline.energy_report_from_accum``, on the CPU at smoke widths with
guidance 7.5.  Requests (tokens and latents) are drawn with numpy from a
seed; the JAX package's weights are converted by ``repro_torch.convert``,
and JAX runs its Pallas kernels in interpret mode.

Port against JAX: the same requests through both slot runtimes, S = 2,
admitted one per step (rows at different steps, an inactive row in the
first step).  Tolerances: the accumulator's integer planes and the energy
summary identical; latents within 2e-2 on both routes, the bound ROADMAP
Queue 3 item 3 gives at guidance 7.5 for a TIPS INT6 code flipped by an
ulp of upstream difference (these requests flip one: one-shot
``generate`` of requests 0 and 1 differs from JAX by 6.4e-3 on the
reference route too), and within ``test_torch_pipeline.py``'s 1e-4 on
the reference route with TIPS off (3.8e-5 there), for a drain of one
policy and for one of a ddim, dpm2m and plms bank.

Port against itself, at knife-edge thresholds (PSSA 1/T, TIPS
1/text_len: every counter moves with its input, as in
``tests/test_continuous.py``): slot images bit-equal to one-shot at equal
batch, the headline bit-identical across slot counts and admission
orders, and two positive controls.  The DBSC FFN quantizes on ONE scale
over the whole (rows x tokens, C) matrix (the JAX package's datapath), so
a DBSC row depends on what shares its batch: slot rows equal one-shot
there only at equal batch content (ROADMAP Queue 3).

On the CPU torch gives a row bits that depend on its batch in two ways
(ROADMAP Queue 3): oneDNN convolves a batch of one on another path than
a larger batch (a few ulps, ``test_cpu_batch_of_one_moves_a_row``), and
with several intra-op threads the split of the rows over the threads
moves a row's bits with its position at some batch sizes.  So this file
runs the port on one intra-op thread, and the headline at one slot is
held against one-shot calls of one row, at two and three slots against
calls of two rows (equal shapes, power-of-two folds).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.diffusion.denoiser import make_denoiser
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import (
    energy_report_banked as j_banked,
    energy_report_from_accum as j_from_accum)
from repro.diffusion.solvers import PhaseSchedule as JPhase
from repro.diffusion.solvers import SamplerPolicy as JPolicy
from repro.kernels.dispatch import KernelPolicy as JKP
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.reuse import ReusePolicy
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import (energy_report_banked,
                                            energy_report_from_accum,
                                            energy_report_multi)
from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
from repro_torch.diffusion.stats import LedgerAccum
from repro_torch.diffusion.unet import unet_forward
from repro_torch.kernels.dispatch import KernelPolicy as TKP

ROUTES = {
    "reference": (JKP(), TKP(), 1e-4),
    "fused_dbsc": (JKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc", interpret=True),
                   TKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc"), 2e-2),
}
BANK = dict(ddim=3, dpm2m=4, plms=4)  # per-family step budgets


def _guided(bk, policy, precision=None):
    cfg = bk.with_kernel_policy(bk.SMOKE, policy)
    if precision is not None:
        cfg = bk.with_precision(cfg, precision)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))


def _knife_edge(cfg):
    """PSSA threshold 1/T and TIPS threshold 1/text_len: the untrained
    model's near-uniform rows would otherwise saturate every counter."""
    t = cfg.unet.latent_size ** 2
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, pssa_threshold=1.0 / t,
        precision=PrecisionPolicy(threshold=1.0 / cfg.unet.text_len)))


def _requests(cfg, n, seed=7):
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


def _t(x):
    return torch.from_numpy(np.array(x))


def _drain(eng, reqs, num_slots, admit, order=None, stagger=False,
           bank=None, policies=None):
    """Serve ``reqs`` through the slot runtime of ``eng``.

    ``admit(state, slot, request, policy_index)`` wraps the package's own
    admit.  ``stagger`` admits at most one request between steps.
    Returns (state, {request: final latents}, {request: image}, steps).
    """
    queue = list(range(len(reqs)) if order is None else order)
    owner, lats, imgs = {}, {}, {}
    state = eng.init_slots(num_slots, bank=bank)

    def fill(state):
        for s in range(num_slots):
            if s not in owner and queue:
                r = queue.pop(0)
                state = admit(state, s, reqs[r],
                              0 if policies is None else policies[r])
                owner[s] = r
                if stagger:
                    break
        return state

    steps = 0
    state = fill(state)
    while owner or queue:
        state = eng.slot_step(state)
        steps += 1
        done = eng.finished_slots(state)
        if done:
            decoded = np.asarray(eng.decode_slots(state, done))
            for j, s in enumerate(done):
                r = owner.pop(s)
                lats[r] = np.asarray(state.latents[s])
                imgs[r] = decoded[j]
            state = eng.retire(state, done)
        state = fill(state)
    return state, lats, imgs, steps


def _t_admit(eng):
    def admit(state, slot, req, pid):
        toks, un, lat = req
        return eng.admit(state, slot, _t(toks), uncond_tokens=_t(un),
                         latents=_t(lat), policy_index=pid)
    return admit


def _j_admit(eng):
    def admit(state, slot, req, pid):
        toks, un, lat = req
        return eng.admit(state, slot, jnp.asarray(toks), None,
                         uncond_tokens=jnp.asarray(un),
                         latents=jnp.asarray(lat), policy_index=pid)
    return admit


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


def _j_on_route(je, cfg):
    """The module's JAX engine, weights shared, on another config."""
    other = copy.copy(je)
    other.cfg = cfg
    other.denoiser = make_denoiser(cfg.unet)
    other._compiled, other._slot_compiled = {}, {}
    other._encode_fn = other._decode_fn = other._admit_fn = None
    return other


def _planes(accum):
    return [np.asarray(getattr(accum, f)).astype(np.int64)
            for f in ("nnz", "ones_xor", "imp", "rows")]


# ---------------------------------------------------------------------------
# Port against JAX
# ---------------------------------------------------------------------------
def _no_tips(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                             tips=False))


def _bank(policy, phase, banked):
    """ddim@3 and dpm2m@4 (a tips_scale schedule); ``banked == "plms"``
    adds plms@4, so the three families share a call."""
    bank = (policy.ddim(BANK["ddim"]), policy.dpm2m(
        BANK["dpm2m"], phases=phase(tips_scale=(2.0, 1.0, 0.5))))
    if banked == "plms":
        bank += (policy.plms(BANK["plms"]),)
    return bank


@pytest.mark.parametrize("route,tips,banked,lat_atol", [
    ("reference", False, False, 1e-4), ("fused_dbsc", True, False, 2e-2),
    ("reference", True, True, 2e-2), ("reference", False, "plms", 1e-4)])
def test_slot_drain_matches_jax(jax_engine, route, tips, banked, lat_atol):
    jpol, tpol, _ = ROUTES[route]
    je, params = jax_engine
    jcfg, tcfg = _guided(j_bk, jpol), _guided(t_bk, tpol)
    if not tips:
        jcfg, tcfg = _no_tips(jcfg), _no_tips(tcfg)
    je = _j_on_route(je, jcfg)
    te = TEngine(tcfg, device="cpu", params=params)
    reqs = _requests(tcfg, 3)
    jbank = tbank = policies = None
    if banked:
        jbank = _bank(JPolicy, JPhase, banked)
        tbank = _bank(SamplerPolicy, PhaseSchedule, banked)
        policies = [0, 1, len(tbank) - 1]
    sj, lj, _, nj = _drain(je, reqs, 2, _j_admit(je), stagger=True,
                           bank=jbank, policies=policies)
    st, lt, it, nt = _drain(te, reqs, 2, _t_admit(te), stagger=True,
                            bank=tbank, policies=policies)
    assert nj == nt and sorted(lt) == [0, 1, 2]
    for r in lt:
        np.testing.assert_allclose(lt[r], lj[r], rtol=0, atol=lat_atol,
                                   err_msg=f"request {r}")
        assert it[r].shape == (128, 128, 3)
    assert st.accum.nnz.dtype == torch.int64
    for pj, pt in zip(_planes(sj.accum), _planes(st.accum)):
        np.testing.assert_array_equal(pt, pj)
    if banked:
        assert (energy_report_banked(tcfg, st.accum, tbank).summary()
                == j_banked(jcfg, sj.accum, jbank).summary())
    else:
        assert (energy_report_from_accum(tcfg, st.accum).summary()
                == j_from_accum(jcfg, sj.accum).summary())


# ---------------------------------------------------------------------------
# Port against itself, knife-edge thresholds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knife(jax_engine):
    cfg = _knife_edge(_guided(t_bk, TKP()))
    return cfg, TEngine(cfg, device="cpu", params=jax_engine[1])


def _one_shot(eng, reqs, batch):
    """The same requests through ``generate`` in batches of ``batch``."""
    lats, imgs, stats = {}, {}, []
    for i in range(0, len(reqs), batch):
        chunk = reqs[i:i + batch]
        out = eng.generate(_t(np.concatenate([r[0] for r in chunk])),
                           uncond_tokens=_t(np.concatenate(
                               [r[1] for r in chunk])),
                           latents=_t(np.concatenate([r[2] for r in chunk])))
        for j in range(len(chunk)):
            lats[i + j] = out.latents[j].numpy()
            imgs[i + j] = out.images[j].numpy()
        stats.append(out.stats)
    return lats, imgs, stats


@pytest.mark.parametrize("route", list(ROUTES))
def test_slot_images_bit_equal_to_one_shot(knife, jax_engine, route):
    """Pairs admitted together run the one-shot batch's rows exactly, on
    both routes (equal batch content, so DBSC's shared scale is equal)."""
    cfg = dataclasses.replace(knife[0], unet=dataclasses.replace(
        knife[0].unet, kernel_policy=ROUTES[route][1]))
    eng = TEngine(cfg, device="cpu", params=jax_engine[1])
    reqs = _requests(cfg, 4)
    ref_lat, ref_img, _ = _one_shot(eng, reqs, batch=2)
    _, lats, imgs, steps = _drain(eng, reqs, 2, _t_admit(eng))
    assert steps == 2 * cfg.ddim.num_inference_steps
    for r in range(4):
        assert lats[r].tobytes() == ref_lat[r].tobytes(), f"request {r}"
        assert imgs[r].tobytes() == ref_img[r].tobytes(), f"request {r}"


def test_dbsc_shared_scale_couples_staggered_rows(knife, jax_engine):
    """On the DBSC route a staggered slot row shares its quantization
    scale with rows at other steps, so it leaves its one-shot latents; on
    the float FFN it stays bit-equal.  The move is a redraw of the INT12 /
    INT6 rounding, held to the one-shot run's own distance between the
    two FFN routes (ROADMAP Queue 3)."""
    reqs = _requests(knife[0], 2)
    slot, solo = {}, {}
    for route in ROUTES:
        cfg = dataclasses.replace(knife[0], unet=dataclasses.replace(
            knife[0].unet, kernel_policy=ROUTES[route][1]))
        eng = TEngine(cfg, device="cpu", params=jax_engine[1])
        _, lats, _, _ = _drain(eng, reqs, 2, _t_admit(eng), stagger=True)
        for r in range(2):
            slot[route, r] = lats[r]
            solo[route, r] = _one_shot(eng, [reqs[r]] * 2, batch=2)[0][0]
    for r in range(2):
        assert slot["reference", r].tobytes() == solo["reference", r].tobytes()
    moved = max(float(np.abs(slot["fused_dbsc", r]
                             - solo["fused_dbsc", r]).max()) for r in range(2))
    quant = max(float(np.abs(solo["fused_dbsc", r]
                             - solo["reference", r]).max()) for r in range(2))
    assert 0.0 < moved <= quant, (moved, quant)


@pytest.mark.parametrize("slots,order", [
    (1, None), (1, [3, 1, 0, 2]), (2, None), (2, [3, 1, 0, 2]), (3, None),
    (3, [2, 0, 3, 1])])
def test_headline_bit_identical_across_slots_and_orders(knife, slots, order):
    """Four requests; a given order is admitted one per step.  The
    one-shot reference runs batches of one row at one slot, else of two."""
    cfg, eng = knife
    reqs = _requests(cfg, 4)
    _, _, stats = _one_shot(eng, reqs, batch=1 if slots == 1 else 2)
    ref = energy_report_multi(cfg, stats).summary()
    state, _, _, _ = _drain(eng, reqs, slots, _t_admit(eng), order=order,
                            stagger=order is not None)
    assert energy_report_from_accum(cfg, state.accum).summary() == ref
    assert state.accum.rows.tolist() == [4] * cfg.ddim.num_inference_steps
    assert not bool(state.active.any())


def test_cpu_batch_of_one_moves_a_row(knife):
    """oneDNN's batch-of-one convolution: one row alone against the same
    row beside another, both fused-CFG UNet calls with TIPS off (its INT6
    codes would amplify the ulps).  Held to a few ulps of eps (ROADMAP
    Queue 3); at two rows and more the row is bit-stable."""
    cfg, eng = knife
    cfg = _no_tips(cfg)
    g = torch.Generator().manual_seed(5)
    lat = torch.randn((3, 16, 16, 4), generator=g)
    ctx = torch.randn((6, 8, 32), generator=g)
    t = torch.tensor([960, 480, 40])

    def eps(rows):
        c = torch.cat([ctx[:3][rows], ctx[3:][rows]])
        return unet_forward(eng.unet_params, lat[rows], t[rows], c, cfg.unet,
                            cfg_dup=True)[0][0]
    one, two, three = eps([0]), eps([0, 1]), eps([0, 1, 2])
    assert torch.equal(two, three)
    assert float((one - two).abs().max()) <= 1e-5 * float(two.abs().max())


def test_headline_moves_with_the_requests(knife):
    """Positive control: at knife-edge thresholds another request set
    moves the integer counters and the headline."""
    cfg, eng = knife
    sa, _, _, _ = _drain(eng, _requests(cfg, 2, seed=7), 2, _t_admit(eng))
    sb, _, _, _ = _drain(eng, _requests(cfg, 2, seed=23), 2, _t_admit(eng))
    assert not torch.equal(sa.accum.nnz, sb.accum.nnz)
    assert (energy_report_from_accum(cfg, sa.accum).summary()
            != energy_report_from_accum(cfg, sb.accum).summary())


def test_unmasked_scatter_moves_the_headline(knife, monkeypatch):
    """Positive control for the active mask: scatter without it and the
    empty rows' counters land in the buckets."""
    cfg, eng = knife
    reqs = _requests(cfg, 2)
    good, _, _, _ = _drain(eng, reqs, 4, _t_admit(eng))  # 2 rows always empty
    orig = LedgerAccum.scatter
    monkeypatch.setattr(
        LedgerAccum, "scatter",
        lambda self, bucket, active, ss:
            orig(self, bucket, torch.ones_like(active), ss))
    bad, _, _, _ = _drain(eng, reqs, 4, _t_admit(eng))
    assert not torch.equal(good.accum.nnz, bad.accum.nnz)
    assert good.accum.rows.tolist() == [2] * cfg.ddim.num_inference_steps
    assert bad.accum.rows[0].item() > 2
    assert (energy_report_from_accum(cfg, good.accum).summary()
            != energy_report_from_accum(cfg, bad.accum).summary())


def test_out_of_range_bucket_is_dropped():
    """A bucket past the end (a banked row past its budget) adds nothing
    anywhere, and the mask zeroes inactive rows before the add."""
    from repro_torch.core.pssa import PSSARowCounters
    from repro_torch.core.tips import TIPSRowCounters
    from repro_torch.diffusion.stats import LayerKey, SlotStats

    ones = torch.ones(3, dtype=torch.int64)
    ss = SlotStats.from_layer_list(
        [LayerKey("down0.0", 16)], [PSSARowCounters(ones * 5, ones * 7)],
        [TIPSRowCounters(ones * 3)])
    acc = LedgerAccum.zeros(4, 1).scatter(
        torch.tensor([1, 4, 2]), torch.tensor([True, True, False]), ss)
    assert acc.nnz[:, 0].tolist() == [0, 5, 0, 0]
    assert acc.ones_xor[:, 0].tolist() == [0, 7, 0, 0]
    assert acc.imp[:, 0].tolist() == [0, 3, 0, 0]
    assert acc.rows.tolist() == [0, 1, 0, 0]


def test_decode_preview_and_chunks(knife):
    cfg, eng = knife
    reqs = _requests(cfg, 3)
    state = eng.init_slots(3)
    for s in range(3):
        state = _t_admit(eng)(state, s, reqs[s], 0)
    state = eng.slot_step(state)
    whole = eng.decode_slots(state)
    chunked = eng.decode_slots(state, [2, 0, 1])       # chunks of 2 and 1
    preview = eng.decode_preview(state, [1])
    assert tuple(whole.shape) == (3, 128, 128, 3)
    assert torch.isfinite(chunked).all()
    np.testing.assert_allclose(chunked.numpy(), whole[[2, 0, 1]].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(preview.numpy(), whole[1:2].numpy(), rtol=0,
                               atol=1e-5)
    assert eng.finished_slots(state) == []
    with pytest.raises(ValueError, match="empty slot list"):
        eng.decode_slots(state, [])


def test_cpu_rows_do_not_depend_on_their_batch(knife):
    """The determinism contract the slot oracle rests on: a row's UNet
    output on the CPU is bit for bit the same whatever shares its batch
    (equal shape), fused CFG and per-row steps included."""
    cfg, eng = knife
    g = torch.Generator().manual_seed(3)
    lat = torch.randn((3, 16, 16, 4), generator=g)
    ctx = torch.randn((6, 8, 32), generator=g)
    t = torch.tensor([960, 640, 0])
    act = torch.tensor([True, False, True])
    out = unet_forward(eng.unet_params, lat, t, ctx, cfg.unet,
                       tips_active=act, cfg_dup=True, row_stats=True)[0]
    lat2, ctx2 = lat.clone(), ctx.clone()
    lat2[1:] = torch.randn((2, 16, 16, 4), generator=g)
    ctx2[[1, 2, 4, 5]] = torch.randn((4, 8, 32), generator=g)
    out2 = unet_forward(eng.unet_params, lat2, t, ctx2, cfg.unet,
                        tips_active=act, cfg_dup=True, row_stats=True)[0]
    assert torch.equal(out[0], out2[0]) and torch.equal(out[3], out2[3])


def test_admit_cfg_contract(jax_engine):
    params = jax_engine[1]
    eng = TEngine(t_bk.SMOKE, device="cpu", params=params)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    state = eng.init_slots(2)
    with pytest.raises(ValueError, match="guidance_scale == 1.0"):
        eng.admit(state, 0, toks, uncond_tokens=toks)
    eng_g = TEngine(_guided(t_bk, TKP()), device="cpu", params=params)
    with pytest.raises(ValueError, match="requires classifier-free"):
        eng_g.admit(eng_g.init_slots(2), 0, toks)
    with pytest.raises(ValueError, match="slot state CFG mode"):
        eng_g.admit(state, 0, toks, uncond_tokens=toks)
    with pytest.raises(ValueError, match="bank-less"):
        eng.admit(state, 0, toks, policy_index=1)
    with pytest.raises(ValueError, match="num_slots"):
        eng.init_slots(0)


def test_init_slots_serves_under_reuse(jax_engine):
    """The call that raised before temporal reuse was ported under slots
    now builds an all-invalid per-slot cache and serves a step."""
    cfg = dataclasses.replace(t_bk.SMOKE, unet=dataclasses.replace(
        t_bk.SMOKE.unet, reuse_policy=ReusePolicy.temporal()))
    eng = TEngine(cfg, device="cpu", params=jax_engine[1])
    state = eng.init_slots(2)
    assert len(state.reuse_cache.layers) == 9
    assert not bool(state.reuse_cache.valid.any())
    toks = torch.zeros((1, 8), dtype=torch.int32)
    state = eng.slot_step(eng.admit(state, 0, toks))
    assert bool(state.reuse_cache.valid.all())
    assert int(state.accum.reuse_computed[0].sum()) == int(
        state.accum.reuse_total[0].sum()) > 0
