"""Training launcher for every LM architecture (port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 100 --batch 4 --seq 512 [--lr 3e-4] [--smoke] \\
      [--grad-compression] [--ckpt-dir DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``--smoke`` trains the
architecture's reduced same-family geometry.  Batches come from
``SyntheticLMDataset(seed=0)``, the optimiser is AdamW on
``linear_warmup_cosine``, and the run resumes from the latest checkpoint
under ``--ckpt-dir`` (``$TMPDIR/repro_torch_<arch>`` by default).  The JAX
launcher's ``--sharded`` (an elastic mesh over the live devices) comes
with multi-GPU training.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.model_flops import param_count
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.train import TrainConfig, Trainer


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, ds, opt, tc = build(args.arch, args.steps, args.batch, args.seq,
                             args.lr, args.smoke, args.grad_compression,
                             args.ckpt_dir)
    print(f"{cfg.name}: {param_count(cfg) / 1e6:.1f} M params, "
          f"device {device}")
    _, history = Trainer(cfg, ds, opt, tc, device=device).run()
    if history:
        print(f"loss {history[0][1]:.4f} -> {history[-1][1]:.4f}")
    return history


if __name__ == "__main__":
    main()
