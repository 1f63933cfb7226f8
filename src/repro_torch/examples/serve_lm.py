"""Batched serving demo: prefill + greedy decode with the paper's features
(port of ``examples/serve_lm.py``).

A small GQA model (the architecture's smoke geometry) serves a batch of
requests: prefill builds the KV cache, then tokens decode step by step.
TIPS (sink-CAS mixed precision) is live in the FFN; the DBSC bit-slice
datapath runs once on an FFN tile of the first layer (the hand-written
kernel on the card, its plain version on the CPU).  The decode cache comes
from ``transformer.decode_cache_from_prefill`` (the JAX example zero-pads
the dense and moe caches, which is the same cache for those families).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
          [--new-tokens 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.bitslice_matmul.ops import bitslice_matmul
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import leaves


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).smoke()
    max_seq = args.prompt_len + args.new_tokens
    print(f"serving {cfg.name} (smoke geometry), batch={args.batch}, "
          f"prompt={args.prompt_len}, decode={args.new_tokens}")

    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)

    with torch.inference_mode():
        # --- prefill ---
        _sync(dev)
        t0 = time.time()
        logits, pcache = T.prefill(params, cfg, tokens=prompts)
        cache = T.decode_cache_from_prefill(cfg, pcache, max_seq)
        del pcache
        _sync(dev)
        mb = sum(a.numel() * a.element_size() for a in leaves(cache)) / 1e6
        print(f"prefill: {time.time() - t0:.2f}s, cache {mb:.1f} MB")

        # --- decode loop (greedy) ---
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        generated = [tok]
        t0 = time.time()
        for i in range(args.new_tokens - 1):
            logits, cache = T.decode_step(params, cache, tok,
                                          args.prompt_len + i, cfg)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(tok)
        _sync(dev)
        dt = time.time() - t0
        out = torch.cat(generated, dim=1)
        print(f"decoded {out.shape[1]} tokens x {args.batch} seqs in "
              f"{dt:.2f}s ({args.batch * out.shape[1] / max(dt, 1e-9):.1f} "
              f"tok/s)")
        print("sample token ids:", out[0, :10].tolist())

        # --- DBSC kernel path on one FFN tile (the serving datapath) ---
        w_up = params["layers"]["w_up"][0].to(torch.float32)
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.relu(torch.randn((args.batch, cfg.d_model), generator=g,
                                   device=dev))
        imp = torch.arange(args.batch, device=dev) % 2 == 0   # TIPS stand-in
        y = bitslice_matmul(x, w_up, important=imp)
        finite = bool(torch.isfinite(y).all())
        print(f"DBSC bit-slice FFN tile: {tuple(y.shape)}, finite={finite}")
    return {"tokens": out.cpu(), "cache_mb": mb, "tile_shape": tuple(y.shape),
            "tile_finite": finite, "decode_s": dt}


if __name__ == "__main__":
    main()
