"""Serving launcher: prefill + greedy batched decode for every LM family
(port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --smoke --batch 4 --prompt-len 32 --new-tokens 32 [--kv-int8] \\
      [--ssd-kernel] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--kv-int8`` keeps
the dense and moe decode caches in int8 (``ArchConfig.kv_cache_dtype``).
``--ssd-kernel`` sets ``ArchConfig.use_ssd_kernel``: the ssm and hybrid
prefill scans then run the hand-written CUDA kernel on the card (its plain
version on the CPU).  The decode cache comes from the prefill cache
through ``transformer.decode_cache_from_prefill``, hybrid ring buffers
included (the JAX launcher decodes a hybrid request from a zeroed cache:
ROADMAP.md, Queue 3 item 18).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import launch_counts, resolve_device
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, params: dict, prompts: torch.Tensor,
          new_tokens: int):
    """Prefill ``prompts`` (B, T), then decode greedily.

    Returns (tokens (B, new_tokens) int64, timings).  The first token
    comes from prefill's logits, each later one from one ``decode_step``.
    ``timings`` holds ``prefill_s`` (prefill and the decode cache built
    from it) and ``decode_s`` (wall seconds, each ended by a device
    synchronise), ``decode_steps``, and ``launches``: the hand-written
    kernels launched in each phase, by name.
    """
    if new_tokens < 1:
        raise ValueError(f"new_tokens={new_tokens} must be at least 1")
    device = prompts.device
    prompt_len = prompts.shape[1]
    counts = [launch_counts()]
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, pcache = T.prefill(params, cfg, tokens=prompts)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        cache = T.decode_cache_from_prefill(cfg, pcache,
                                            prompt_len + new_tokens)
        del pcache
        _sync(device)
        prefill_s = time.perf_counter() - t0
        counts.append(launch_counts())
        out = [tok]
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            logits, cache = T.decode_step(params, cache, tok,
                                          prompt_len + i, cfg)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    counts.append(launch_counts())
    launches = {phase: {k: n - start.get(k, 0) for k, n in end.items()}
                for phase, start, end in (("prefill", counts[0], counts[1]),
                                          ("decode", counts[1], counts[2]))}
    return torch.cat(out, dim=1), {"prefill_s": prefill_s,
                                   "decode_s": decode_s,
                                   "decode_steps": new_tokens - 1,
                                   "launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; the card ('cuda') by default")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (dense and moe)")
    ap.add_argument("--ssd-kernel", action="store_true",
                    help="prefill through the fused SSD scan kernel")
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="greedy decoding (the only decoding there is; "
                         "accepted so that the JAX command line runs)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.kv_int8:
        cfg = cfg.scaled(kv_cache_dtype="int8")
    if args.ssd_kernel:
        cfg = cfg.scaled(use_ssd_kernel=True)

    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=torch.Generator(
                                device=device).manual_seed(1),
                            device=device)
    seq, timings = serve(cfg, params, prompts, args.new_tokens)
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{timings['prefill_s']:.2f}s on {device}")
    dt = timings["decode_s"]
    print(f"decode: {seq.shape[1]} tokens x {args.batch} in {dt:.2f}s "
          f"({args.batch * seq.shape[1] / max(dt, 1e-9):.1f} tok/s)"
          f"{' [int8 KV]' if args.kv_int8 else ''}")
    print("sample:", seq[0, :12].tolist())


if __name__ == "__main__":
    main()
