"""What the engine's mesh mode costs at degree 1, on the card.

BK-SDM-Tiny at full width on the slice route (fused attention + DBSC),
batch 1, 25 steps, guidance 7.5, random weights from a seed: one
``generate`` unsharded, under ``make_data_mesh(1)`` in a one-rank NCCL
group, and under the mesh with ``data_max`` / ``data_sum`` made the
identity (the mesh path without its collectives), alternated for
``--rounds`` rounds after two warm-up calls each; then the host time of
one ``data_max``, one ``data_sum`` and one bare ``all_reduce`` in a loop of
1000; then a ``torch.profiler`` pass over one unsharded and one mesh
generate, with each one's count of ``cudaStreamSynchronize`` and of
collectives and its largest host items.

    PYTHONPATH=src python3 scripts/mesh_overhead.py [--rounds 3]

Prints the card's name and power limit, the readings, then one JSON line
of the s/image lists.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist

from repro_torch.configs import bk_sdm
from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.launch import mesh as M


def _tokens(cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(1, cfg.text.vocab_size, (1, cfg.text.max_len),
                         generator=g, device="cuda", dtype=torch.int32)
    toks[:, 0] = 0
    return toks, torch.zeros_like(toks)


def _loop_us(fn, n: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over ``n`` calls, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _profile(eng, run, label: str, top: int = 8) -> None:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(eng)
    ka = prof.key_averages()
    by_key = {k.key: k for k in ka}
    syncs = by_key.get("cudaStreamSynchronize")
    comms = by_key.get("c10d::allreduce_")
    print(f"profile {label}: wall {eng.last_wall_s:.4f} s; "
          f"cudaStreamSynchronize {syncs.count if syncs else 0} calls "
          f"{(syncs.self_cpu_time_total if syncs else 0) / 1e3:.2f} ms; "
          f"allreduce {comms.count if comms else 0} calls")
    for k in sorted(ka, key=lambda k: -k.self_cpu_time_total)[:top]:
        print(f"profile {label}:   {k.key[:56]:56s} {k.count:6d} calls "
              f"{k.self_cpu_time_total / 1e3:9.2f} ms host")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = bk_sdm.with_kernel_policy(bk_sdm.CONFIG, KernelPolicy(
        self_attention="fused", cross_attention="fused", ffn="dbsc"))
    eng = DiffusionEngine(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    toks, un = _tokens(cfg, 7)
    lat = eng.init_latents(1, torch.Generator(device="cuda").manual_seed(8))

    def run(e):
        e.generate(toks, uncond_tokens=un, latents=lat.clone())
        return e.last_wall_s

    real = (M.data_max, M.data_sum)
    walls = {"unsharded": [], "mesh": [], "mesh, collectives off": []}
    with M.process_group(device="cuda"):
        mesh = M.make_data_mesh(1)
        meng = DiffusionEngine(cfg, params=params, mesh=mesh)
        for e in (eng, meng, eng, meng):
            run(e)
        for _ in range(args.rounds):
            walls["unsharded"].append(run(eng))
            walls["mesh"].append(run(meng))
            M.data_max = M.data_sum = lambda x: x
            try:
                walls["mesh, collectives off"].append(run(meng))
            finally:
                M.data_max, M.data_sum = real
            walls["unsharded"].append(run(eng))
        for k, v in walls.items():
            print(f"s/image {k}: {', '.join(f'{w:.4f}' for w in v)}")
        x = torch.ones((), device="cuda")
        counters = torch.ones((3,), dtype=torch.int64, device="cuda")
        group = M.data_group(mesh)
        with M.use_mesh(mesh):
            us = {"data_max": _loop_us(lambda: M.data_max(x)),
                  "data_sum": _loop_us(lambda: M.data_sum(counters)),
                  "bare all_reduce": _loop_us(
                      lambda: dist.all_reduce(x, group=group))}
        print("host us a call: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in us.items()))
        _profile(eng, run, "unsharded")
        _profile(meng, run, "mesh")
    print(json.dumps(walls))


if __name__ == "__main__":
    main()
