"""The comparison that decides ``correct``.

Once the window has closed and the serving state is freed, a sample of
the requests the window finished, drawn from the seed, is run again by
the plain reference, each request alone, from the same weights, tokens
and latents.  The sample takes one request from each of as many strata
of neighbouring slots as it has requests, so both halves of the slot
batch are always in it, and one of the longest tier among them.  Two
numbers are held to the configuration's limits:

* ``image_rel_rms``: the widest over the sample of ||image - reference||
  / ||reference|| (the served image against the reference's decode of
  its own trajectory: text tower, denoiser with PSSA, TIPS and DBSC,
  solver and VAE decoder together);
* ``counter_rel_gap``: the widest over the sample, the three ledger
  counters (PSSA kept scores, PSSA patch-XOR population, TIPS important
  tokens) and the blocks of |program - reference| / reference, each
  summed over the request's steps.  The program's are its row's counters
  as each step returned them.

A sampled request that did not run its tier's budget of steps is noted,
and the run is not correct; so is a window in which the counters the
harness captured do not line up one to a slot step.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

import traffic
from reference import sampling

NAMES = ("image_rel_rms", "counter_rel_gap")


def sample(finished: list, k: int, seed: int, model: dict,
           slots: int) -> list:
    """``k`` of the finished requests: the slot batch cut into ``k``
    strata of neighbouring slots and one request drawn from each, one of
    the longest tier first; strata with no finished request are made up
    from the rest."""
    rng = random.Random(seed)
    longest = max(traffic.budget(model, r["tier"]) for r in finished)
    strata = [[] for _ in range(k)]
    for r in finished:
        strata[r["slot"] * k // slots].append(r)
    strata = [s for s in strata if s]
    tops = [s for s in strata
            if any(traffic.budget(model, r["tier"]) == longest for r in s)]
    top = rng.choice(tops)
    pick = [rng.choice([r for r in top
                        if traffic.budget(model, r["tier"]) == longest])]
    pick += [rng.choice(s) for s in strata if s is not top]
    rest = [r for r in finished if all(r is not p for p in pick)]
    return pick + rng.sample(rest, min(k - len(pick), len(rest)))


def reference_run(model, params, inputs, r, dev, tf32: bool):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        toks, lat = inputs[r["rid"]]
        image, counters = sampling.generate(
            params, model, toks.to(dev), torch.zeros_like(toks).to(dev),
            lat.to(dev), r["tier"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return image[0].cpu().numpy(), counters.cpu().numpy()


def gaps(image, counters, ref_image, ref_counters) -> dict:
    """The two numbers of one request."""
    d = np.asarray(image, np.float64) - np.asarray(ref_image, np.float64)
    rel = float(np.linalg.norm(d) / max(np.linalg.norm(ref_image), 1e-30))
    p = counters.sum(axis=0).astype(np.float64)
    q = ref_counters.sum(axis=0).astype(np.float64)
    return {"image_rel_rms": rel,
            "counter_rel_gap": float(np.max(np.abs(p - q)
                                            / np.maximum(q, 1.0)))}


def compare(model, seed, params, finished, reqs, inputs, rec, dev, slots):
    """(checks {name: {"value", "limit"}}, notes, the reference's
    seconds)."""
    notes = []
    limits = model["check"]["limits"]
    worst = dict.fromkeys(NAMES, 0.0)
    failed = None if finished else "no request finished in the window"
    failed = rec.misaligned() or failed
    if failed:
        return ({n: {"value": 1e30, "limit": limits[n]}
                 for n in NAMES}, [failed], 0.0)
    t = time.perf_counter()
    for r in sample(finished, model["check"]["requests"], seed, model,
                    slots):
        steps = r["finish_round"] - r["admit_round"]
        if steps != traffic.budget(model, r["tier"]):
            notes.append(f"request {r['rid']} ran {steps} steps of its "
                         f"tier {r['tier']}")
            continue
        ours = rec.counters(range(r["admit_round"], r["finish_round"]))
        ref_image, ref_counters = reference_run(model, params, inputs, r,
                                                dev, False)
        for k, v in gaps(reqs[r["rid"]].image, ours[:, r["slot"]],
                         ref_image, ref_counters).items():
            worst[k] = max(worst[k], v)
    checks = {n: {"value": worst[n], "limit": limits[n]} for n in NAMES}
    return checks, notes, time.perf_counter() - t
