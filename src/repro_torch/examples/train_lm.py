"""End-to-end training of a ~100M-parameter LM (port of
``examples/train_lm.py``).

Exercises the training path end to end: the deterministic data pipeline
-> the train step (remat, optional int8 gradient compression) ->
fault-tolerant checkpointing (kill it mid-run and relaunch: it resumes
from the latest checkpoint under ``--ckpt-dir``).  ``--smoke`` trains the
config's reduced same-family geometry.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      (the second run resumes)
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.model_flops import param_count
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.train import TrainConfig, Trainer

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_lm")


def make_100m_config():
    """llama3-family config scaled to ~100M params."""
    return get_arch("llama3-8b").scaled(
        name="llama3-100m",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=50304,
        tips=False, pssa=False,          # vanilla training numerics
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced same-family geometry")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_100m_config()
    if args.smoke:
        cfg = cfg.smoke()
    print(f"arch {cfg.name}: {param_count(cfg) / 1e6:.1f} M params")

    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch, seed=0)
    opt = AdamW(lr=linear_warmup_cosine(3e-4, warmup=20,
                                        total_steps=max(args.steps, 21)))
    tc = TrainConfig(steps=args.steps, checkpoint_every=50, log_every=10,
                     checkpoint_dir=args.ckpt_dir,
                     grad_compression=args.grad_compression)
    trainer = Trainer(cfg, ds, opt, tc, device=dev)
    _, history = trainer.run()
    if not history:
        print(f"\nnothing to train: {args.ckpt_dir} holds step "
              f"{args.steps} already")
        return {"history": history}
    first, last = history[0][1], history[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return {"history": history, "params": param_count(cfg)}


if __name__ == "__main__":
    main()
