"""Training CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --seq-len 256 --batch 8 [--reduced] [--ckpt-dir DIR]

The flags are the reference CLI's (``python -m repro.launch.train``) plus
``--device``: the run is on the CUDA device unless ``--device`` says
otherwise (``--device cpu`` runs the kernels' plain versions), and with
neither a device nor a GPU it stops with an error.  Zipf token data from
``repro_torch.data``; checkpoints under ``--ckpt-dir`` every
``--checkpoint-every`` steps.
"""
from __future__ import annotations

import argparse

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches
from repro_torch.train import Trainer


def main(argv=None) -> None:
    """CLI entry: train a (reduced) arch on Zipf token data, with
    optional periodic checkpointing via CheckpointManager."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     optimizer=args.optimizer, grad_accum=args.grad_accum,
                     checkpoint_every=args.checkpoint_every
                     if args.ckpt_dir else 0)
    trainer = Trainer(cfg, tc, ckpt_dir=args.ckpt_dir, device=args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    batch_size=args.batch)
    report = trainer.run(batches(dc), args.steps)
    print(f"device {trainer.model.device}: steps={report.steps_done} loss "
          f"{report.losses[0]:.3f} -> {report.final_loss:.3f} "
          f"retries={report.retries} stragglers={report.straggler_steps}")


if __name__ == "__main__":
    main()
