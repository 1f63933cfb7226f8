"""Serving launcher: prefill + greedy batched decode (port of
``repro.launch.serve``; the ssm family only).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --smoke --batch 4 --prompt-len 32 --new-tokens 32 [--ssd-kernel] \\
      [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--ssd-kernel`` sets
``ArchConfig.use_ssd_kernel``: prefill's scan then runs the hand-written
CUDA kernel on the card (its plain version on the CPU).  For the ssm
family the prefill cache is the decode cache.
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
    ``timings`` holds ``prefill_s`` and ``decode_s`` (wall seconds, each
    ended by a device synchronise), ``decode_steps``, and ``launches``:
    the hand-written kernels launched in each phase, by name.
    """
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"serve runs the 'ssm' family only, not {cfg.family!r}; see "
            f"ROADMAP.md, Queue 1 item 7")
    if new_tokens < 1:
        raise ValueError(f"new_tokens={new_tokens} must be at least 1")
    device = prompts.device
    prompt_len = prompts.shape[1]
    counts = [launch_counts()]
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, tokens=prompts)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
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
    ap.add_argument("--ssd-kernel", action="store_true",
                    help="prefill through the fused SSD scan kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
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
          f"({args.batch * seq.shape[1] / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", seq[0, :12].tolist())


if __name__ == "__main__":
    main()
