"""The one traffic generator: requests and their arrival times from a mix's
parameter file and the seed.

Every request draws its prompt tokens and initial latents from a CPU
generator of its own, seeded from ``(seed, index)``, the arithmetic of the
port's ``scheduler.request_generator`` / ``make_requests``: a request's
inputs depend on neither the number of requests nor the device.  The
empty prompt (all zero tokens) is the unconditional side of guidance.

A mix file gives ``slots`` (rows of the served slot batch), ``tiers``
(the quality tiers the requests cycle through, in order; ``["config"]``
is the configuration's own DDIM schedule and serves without a bank) and
``arrivals``:

* ``backlog``: the queue never empties.  The first ``slots`` requests
  arrive spread evenly over one mean budget of router rounds, so the rows
  finish evenly through the round cycle; every later request is waiting
  from the last of those arrivals on.  The window opens once every slot
  has finished one request.
* ``bursty``: bursts of ``burst`` requests every ``gap_s`` seconds from
  the stream's start.  The window opens at burst ``ramp_bursts`` and
  takes every request that arrives before it closes; arrivals stop there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.sampling import TIERS


def request_generator(seed: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def request_inputs(model: dict, seed: int, index: int):
    """(tokens (1, T) int32, latents (1, S, S, C) float32), on the CPU."""
    g = request_generator(seed, index)
    unet = model["unet"]
    s, c = unet["latent_size"], unet["in_channels"]
    toks = torch.randint(0, model["text"]["vocab_size"],
                         (1, model["text"]["max_len"]), generator=g,
                         dtype=torch.int32)
    return toks, torch.randn((1, s, s, c), generator=g)


def budget(model: dict, tier: str) -> int:
    if tier == "config":
        return model["ddim"]["num_inference_steps"]
    return TIERS[tier][1]


def mean_budget(model: dict, mix: dict) -> float:
    return sum(budget(model, t) for t in mix["tiers"]) / len(mix["tiers"])


def plan(model: dict, mix: dict, seconds: float, round_s: float) -> dict:
    """Arrival times (seconds from the stream's start), each request's tier
    and, for ``bursty``, where the window lies.  ``round_s`` is one router
    round's time measured in set-up (it spaces the backlog's first rows
    and sizes its queue)."""
    slots = mix["slots"]
    tiers = mix["tiers"]
    kind = mix["arrivals"]
    if kind == "backlog":
        spread = mean_budget(model, mix) / slots * round_s
        first = [k * spread for k in range(slots)]
        # rounds until every slot finished one request, the window, and
        # a margin for slower rounds than the one measured
        rounds = (2 * mean_budget(model, mix) + seconds / round_s) * 1.5 + 8
        n = slots + math.ceil(rounds * slots / mean_budget(model, mix))
        arrivals = first + [first[-1]] * (n - slots)
        window = None
    elif kind == "bursty":
        gap, burst = mix["gap_s"], mix["burst"]
        start = mix["ramp_bursts"] * gap
        n_bursts = mix["ramp_bursts"] + math.ceil(seconds / gap)
        arrivals = [j * gap for j in range(n_bursts) for _ in range(burst)]
        arrivals = [a for a in arrivals if a < start + seconds]
        window = (start, start + seconds)
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    return {"arrivals": arrivals,
            "tiers": [tiers[i % len(tiers)] for i in range(len(arrivals))],
            "window": window}
