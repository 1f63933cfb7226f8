"""The checkpoint store's leaves one at a time against in its thread pool,
on the card.

``save_checkpoint`` then ``load_checkpoint`` of qwen2-moe-a2.7b's training
state cut to 2 layers, as the smoke's train phase checkpoints it (1.763 B
parameters in bf16 plus AdamW's two float32 moments, 17.6 GB), with
``store._THREADS`` at 1 (the leaves in order, one at a time) and at the
store's own count, alternating which runs first in each pair.  The load
reads what the save just wrote, so it reads warm from the page cache.

    PYTHONPATH=src python3 scripts/checkpoint_store_ab.py [--pairs 4]

Prints each run's save and load seconds, then one JSON line of them all.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint, store
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.tree import leaves

LAYERS = 2


def timed_round(state, threads: int, root: str) -> dict:
    store._THREADS = threads
    d = tempfile.mkdtemp(dir=root)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(d, 1, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = load_checkpoint(d, 1, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(back)))
    if not same:
        raise SystemExit(f"threads {threads}: the loaded state differs")
    return {"threads": threads, "save_s": save_s, "load_s": load_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_store_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cfg = get_arch("qwen2-moe-a2.7b").scaled(num_layers=LAYERS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    state = (params, AdamW().init(params),
             torch.zeros((), dtype=torch.float32, device="cuda"))
    gb = sum(x.numel() * x.element_size() for x in leaves(state)) / 1e9
    pooled = store._THREADS
    print(f"{card}; {os.cpu_count()} CPU cores; qwen2-moe-a2.7b at "
          f"{LAYERS} layers: {len(leaves(state))} leaves, {gb:.2f} GB; "
          f"threads 1 against {pooled}")
    runs = []
    root = tempfile.mkdtemp(prefix="store_ab_")
    try:
        for p in range(args.pairs):
            order = (1, pooled) if p % 2 == 0 else (pooled, 1)
            for threads in order:
                r = timed_round(state, threads, root)
                r["pair"] = p
                runs.append(r)
                print(f"pair {p} threads {threads}: save {r['save_s']:.3f} "
                      f"s, load {r['load_s']:.3f} s (loaded state equal)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        store._THREADS = pooled
    out = {"device": card, "gb": gb, "runs": runs}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
