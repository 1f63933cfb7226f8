"""The dense FLOP count of the images' work, taken once from the
configuration's shapes: ``FlopCounterMode`` over the plain reference on
meta tensors, with the three features replaced by their dense float
operations.  It is the same whatever implements the model.

Units: one request-step is both halves of the guidance batch through the
denoiser; one prompt is one text encode (a request takes two: its prompt
and the empty one); one image is one VAE decode.
"""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

import weights
from reference import sampling, text, vae


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _units(model_json: str) -> dict:
    model = json.loads(model_json)
    w = weights.meta(model)
    unet, t = model["unet"], model["text"]
    s, c = unet["latent_size"], unet["in_channels"]
    meta = {"device": "meta"}
    lat = torch.empty((2, s, s, c), **meta)
    ctx = torch.empty((2, t["max_len"], t["d_model"]), **meta)
    steps = torch.empty((2,), dtype=torch.int64, **meta)
    tips = torch.empty((2,), dtype=torch.bool, **meta)
    fam = sampling.family(model["family"])
    toks = torch.empty((1, t["max_len"]), dtype=torch.int64, **meta)
    return {
        "request_step": _count(lambda: fam.forward(
            w["unet"], lat, steps, ctx, unet, model["features"], tips, 1,
            dense=True)),
        "prompt": _count(lambda: text.encode(w["text"], toks, t)),
        "image": _count(lambda: vae.decode(w["vae"], lat[:1],
                                           model["vae"])),
    }


def units(model: dict) -> dict:
    """FLOPs of one request-step, one prompt encode and one image decode."""
    return _units(json.dumps(model, sort_keys=True))
