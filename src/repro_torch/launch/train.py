"""Training launcher for every LM architecture (port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 100 --batch 4 --seq 512 [--lr 3e-4] [--smoke] \\
      [--grad-compression] [--ckpt-dir DIR] [--device cpu] \\
      [--sharded [--mesh N]]

Runs on the card unless ``--device cpu`` is given; ``--smoke`` trains the
architecture's reduced same-family geometry.  Batches come from
``SyntheticLMDataset(seed=0)``, the optimiser is AdamW on
``linear_warmup_cosine``, and the run resumes from the latest checkpoint
under ``--ckpt-dir`` (``$TMPDIR/repro_torch_<arch>`` by default).

``--sharded`` trains on ``make_elastic_mesh()`` over the live ranks (all
tensor-parallel up to 16) with ``ShardCtx(mesh, dp_axes=("data",))``.
The ranks start as ``serve_diffusion --mesh`` starts them: ``--mesh N``
ranks, one a card (NCCL; every card by default) or N gloo processes with
``--device cpu`` (1 by default).  A one-rank run joins the process group
already running in this process, or starts its own.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.model_flops import param_count
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.train import TrainConfig, Trainer

SHARDED_TIMEOUT_S = 3600.0      # --sharded --mesh N: the group's whole run


def build(arch: str, steps: int, batch: int, seq: int, lr: float,
          smoke: bool = False, grad_compression: bool = False,
          ckpt_dir: str | None = None):
    """-> (cfg, dataset, AdamW, TrainConfig) as the CLI builds them."""
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    ds = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        embedding_input=cfg.embedding_input, d_model=cfg.d_model)
    opt = AdamW(lr=linear_warmup_cosine(
        lr, warmup=min(20, steps // 10 + 1), total_steps=steps))
    tc = TrainConfig(
        steps=steps, checkpoint_every=max(10, steps // 5),
        log_every=max(1, steps // 20),
        checkpoint_dir=ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_{cfg.name}"),
        grad_compression=grad_compression)
    return cfg, ds, opt, tc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family geometry (CPU-trainable)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the card ('cuda') by default")
    ap.add_argument("--sharded", action="store_true",
                    help="shard over the live ranks (elastic mesh)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="with --sharded: the ranks, one a card (every "
                         "card by default) or gloo processes with "
                         "--device cpu (1 by default)")
    args = ap.parse_args(argv)
    if args.mesh < 0:
        ap.error("--mesh must be >= 0")
    if args.mesh and not args.sharded:
        ap.error("--mesh counts the ranks of --sharded; add --sharded")

    device = resolve_device(args.device)
    build_args = (args.arch, args.steps, args.batch, args.seq, args.lr,
                  args.smoke, args.grad_compression, args.ckpt_dir)
    cfg, ds, opt, tc = build(*build_args)
    print(f"{cfg.name}: {param_count(cfg) / 1e6:.1f} M params, "
          f"device {device}")
    if not args.sharded:
        history = Trainer(cfg, ds, opt, tc, device=device).run()[1]
    else:
        n = args.mesh or (torch.cuda.device_count() if device.type == "cuda"
                          else 1)
        mesh_mod.require_devices(n, device)
        if n > 1:
            history = mesh_mod.spawn(_train_on_mesh, n, (build_args,),
                                     device, SHARDED_TIMEOUT_S)[0]
        elif dist.is_initialized():
            history = _train_on_mesh(build_args)
        else:
            with mesh_mod.process_group(device=device):
                history = _train_on_mesh(build_args)
    if history:
        print(f"loss {history[0][1]:.4f} -> {history[-1][1]:.4f}")
    return history


def _train_on_mesh(build_args) -> list:
    """One rank of ``--sharded``: the run on the elastic mesh over every
    rank of the group; -> its (step, loss) history."""
    cfg, ds, opt, tc = build(*build_args)
    mesh = mesh_mod.make_elastic_mesh()
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",))
    if dist.get_rank() == 0:
        print(f"elastic mesh: {mesh_mod.mesh_shape(mesh)}")
    trainer = Trainer(cfg, ds, opt, tc, device=mesh_mod.group_device(),
                      ctx=ctx)
    return trainer.run()[1]


if __name__ == "__main__":
    main()
