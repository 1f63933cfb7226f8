"""A whole run with the timed path broken underneath comes out not
correct: the harness's look for a card is skipped (the run is on the CPU
at SMOKE size), the rest of the run is the benchmark's own.

The faults a diffusion cell can have: a step that returns its state
unchanged (the rows never advance, or advance without their latents
moving), half of the slot batch left out of the step, an image altered
where it is decoded, and a ledger counter altered where the step returns
it.  The cells run on one card, so there is no exchange between chips to
leave out."""
import dataclasses
import json

import pytest
import torch

import check
import harness
import smoke


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged(engine):
    engine.slot_step = lambda state: state


def _frozen_latents(engine):
    step = engine.slot_step

    def frozen(state):
        return dataclasses.replace(step(state), latents=state.latents)
    engine.slot_step = frozen


def _half_batch(engine):
    step = engine.slot_step

    def half(state):
        new = step(state)
        keep = new.latents.clone()
        h = state.num_slots // 2
        keep[h:] = state.latents[h:]
        return dataclasses.replace(new, latents=keep)
    engine.slot_step = half


def _altered_image(engine):
    decode = engine.decode_slots

    def altered(state, slots=None):
        out = decode(state, slots)
        return torch.cat([-out[:1], out[1:]])
    engine.decode_slots = altered


def _altered_counter(engine):
    apply_ = engine._unet_apply

    def altered(*a, **kw):
        eps, stats = apply_(*a, **kw)[:2]
        first = stats.pssa[0]
        pssa = (first._replace(nnz=first.nnz * 2),) + stats.pssa[1:]
        return eps, dataclasses.replace(stats, pssa=pssa)
    engine._unet_apply = altered


FAULTS = {"unchanged_state": _unchanged, "frozen_latents": _frozen_latents,
          "half_batch": _half_batch, "altered_image": _altered_image,
          "altered_counter": _altered_counter}
CELLS = [("bksdm-small.backlog8", "bksdm-small", "backlog8"),
         ("dit-s2.bursty32", "dit-s2", "bursty32")]


# every finished request, or as many as the cell's own check samples
# (over 4 slots, so that the sample's strata of slots matter).  The
# limits are the SMOKE geometry's: its sound runs read up to ~4e-3 on
# BK-SDM, over the full-size cells' limits.
SAMPLES = {"all": (100, 2), "cell": (None, 4)}


def _run(workload, config, traffic, fault, sample="all"):
    model = smoke.model(config)
    requests, slots = SAMPLES[sample]
    model["check"]["requests"] = requests or json.loads(
        (smoke.BENCH / "configs" / f"{config}.json").read_text()
    )["check"]["requests"]
    model["check"]["limits"] = {"image_rel_rms": 0.05,
                                "counter_rel_gap": 0.01}
    return harness.run(workload, 77, 1.5, False, device="cpu", model=model,
                       mix=smoke.mix(traffic, slots), fault=fault,
                       ramp_limit_s=20.0)


@pytest.mark.parametrize("sample", sorted(SAMPLES))
@pytest.mark.parametrize("workload,config,traffic", CELLS)
def test_sound_run_is_correct(workload, config, traffic, sample):
    assert _run(workload, config, traffic, None, sample)["correct"]


@pytest.mark.parametrize("sample", sorted(SAMPLES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,config,traffic", CELLS)
def test_fault_is_not_correct(workload, config, traffic, fault, sample):
    out = _run(workload, config, traffic, FAULTS[fault], sample)
    assert not out["correct"], out


@pytest.mark.parametrize("config,traffic", [("bksdm-small", "backlog8"),
                                            ("bksdm-small", "tiers8"),
                                            ("dit-s2", "backlog32")])
def test_sample_holds_both_halves_of_the_slot_batch(config, traffic):
    """At the cell's own slot count and sample size, on any seed: a row
    from each half of the batch, and one of the longest tier."""
    model = json.loads((smoke.BENCH / "configs" / f"{config}.json")
                       .read_text())
    mix = json.loads((smoke.BENCH / "traffic" / f"{traffic}.json")
                     .read_text())
    slots, k = mix["slots"], model["check"]["requests"]
    tiers = mix["tiers"]
    finished = [{"rid": i, "slot": i % slots, "tier": tiers[i % len(tiers)]}
                for i in range(7 * slots)]
    longest = max(check.traffic.budget(model, t) for t in tiers)
    for seed in range(2000):
        got = check.sample(finished, k, seed, model, slots)
        halves = {r["slot"] * 2 // slots for r in got}
        assert len(got) == k and halves == {0, 1}, (seed, got)
        assert len({r["rid"] for r in got}) == k
        assert check.traffic.budget(model, got[0]["tier"]) == longest


def _denoiser_calls(n):
    """A step that calls the denoiser ``n`` times, as the harness's
    wrapper sees it (a fused or split denoiser call)."""
    def fault(engine):
        step, inner = engine.slot_step, engine._unet_apply

        def stepped(state):
            wrapped = engine._unet_apply      # the harness's, at call time

            def calls(*a, **kw):
                for _ in range(n - 1):
                    wrapped(*a, **kw)
                return (wrapped if n else inner)(*a, **kw)
            engine._unet_apply = calls
            try:
                return step(state)
            finally:
                engine._unet_apply = wrapped
        engine.slot_step = stepped
    return fault


@pytest.mark.parametrize("calls", [0, 2])
def test_counters_out_of_step_are_not_judged(calls):
    """Counters captured other than once a step cannot be lined up with
    the steps: the run is not correct, and says why."""
    out = _run("dit-s2.bursty32", "dit-s2", "bursty32",
               _denoiser_calls(calls))
    assert not out["correct"] and "exactly once" in out["why"], out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", ["bksdm-small.backlog8",
                                      "dit-s2.backlog32", "dit-s2.bursty32",
                                      "bksdm-small.tiers8"])
def test_half_batch_fails_at_the_cells_size(workload, cuda):
    """Half of the slot batch left out, at the cell's own size, sample and
    limits, on the card, over a short window."""
    out = harness.run(workload, 20261020, 5.0, False, fault=_half_batch)
    assert not out["correct"], out
    assert out["checks"]["image_rel_rms"]["value"] > out["checks"][
        "image_rel_rms"]["limit"], out
