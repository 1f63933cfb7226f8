"""Fig. 9(a) analogue: 2-D visualization of TIPS-spotted important pixels
(port of ``examples/tips_visualization.py``).

The paper compares the binary importance map (white = important = INT12)
with the generated image to show TIPS tracks prompt relevance.  Without
pretrained weights the relevance field is synthetic (a torch copy of the
JAX package's ``benchmarks/bench_tips`` generator, drawn from a torch
generator), so this demo validates the same property the figure shows: the
spotted map recovers the prompt-relevance structure planted in the
cross-attention scores.

Run:  PYTHONPATH=src python -m repro_torch.examples.tips_visualization
          [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import tips
from repro_torch.kernels.runtime import resolve_device


def smooth_field(generator: torch.Generator, res: int, channels: int,
                 base: int = 2, octaves: int = 3) -> torch.Tensor:
    """Multi-octave smooth random field (res, res, channels): a coarse
    normal grid per octave, upsampled bilinearly (half-pixel centres) and
    weighted by 2^-octave."""
    dev = generator.device
    out = torch.zeros((res, res, channels), device=dev)
    for o in range(octaves):
        r = min(res, base << o)
        coarse = torch.randn((1, channels, r, r), generator=generator,
                             device=dev)
        up = F.interpolate(coarse, size=(res, res), mode="bilinear",
                           align_corners=False)
        out = out + up[0].permute(1, 2, 0) / (2.0 ** o)
    return out


def synthetic_cross_attention(generator: torch.Generator, res: int = 64,
                              text_len: int = 77, heads: int = 8,
                              relevance_scale: float = 3.0,
                              unimportant_frac: float = 0.56
                              ) -> torch.Tensor:
    """(heads, T, text_len) softmax rows over [CLS, text...] keys.

    Pixels tied to the prompt put their softmax mass on the text tokens
    (small CAS); background pixels dump theirs on the CLS sink (large
    CAS).  ``unimportant_frac`` of the image is background (the paper
    measures ~56 % per active iteration)."""
    dev = generator.device
    rel = smooth_field(generator, res, 1)[..., 0].reshape(-1)    # (T,)
    rel = rel - torch.quantile(rel, unimportant_frac)   # > 0: prompt-related
    t = res * res
    base = torch.randn((heads, t, text_len), generator=generator,
                       device=dev) * 0.5
    boost = torch.zeros((heads, t, text_len), device=dev)
    boost[:, :, 1:] += relevance_scale * torch.relu(rel)[None, :, None]
    sink = (rel < 0).to(torch.float32) + torch.relu(-rel)
    boost[:, :, 0] += relevance_scale * sink[None, :]
    return torch.softmax(base + boost, dim=-1)


def ascii_map(mask2d) -> str:
    chars = np.where(np.asarray(mask2d), "#", ".")
    return "\n".join("".join(row) for row in chars)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    res = 64
    probs = synthetic_cross_attention(
        torch.Generator(device=dev).manual_seed(7), res=res)
    r = tips.spot(probs, threshold=0.05)
    mask = r.important.cpu().numpy().reshape(res, res)
    low = float(r.low_precision_ratio)

    print(f"important-pixel ratio: {mask.mean() * 100:.1f} % "
          f"(low-precision: {low * 100:.1f} %)")
    # the planted relevance field is smooth -> the spotted map must be
    # spatially coherent, not salt-and-pepper: neighbour agreement >> 50 %
    agree_h = float((mask[:, 1:] == mask[:, :-1]).mean())
    agree_v = float((mask[1:, :] == mask[:-1, :]).mean())
    print(f"spatial coherence: horizontal {agree_h * 100:.1f} %, "
          f"vertical {agree_v * 100:.1f} %")
    if not (agree_h > 0.85 and agree_v > 0.85):
        raise AssertionError("map should be region-like")

    print("\nTIPS importance map (64x64, # = important = INT12):")
    print(ascii_map(mask[::2, ::1]))       # halve rows for terminal aspect
    return {"important_ratio": float(mask.mean()), "low_precision_ratio": low,
            "agree_h": agree_h, "agree_v": agree_v}


if __name__ == "__main__":
    main()
