"""Training CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --seq-len 256 --batch 8 [--reduced] [--ckpt-dir DIR]

The flags are the reference CLI's (``python -m repro.launch.train``) plus
``--device``: the run is on the CUDA device unless ``--device`` says
otherwise (``--device cpu`` runs the kernels' plain versions), and with
neither a device nor a GPU it stops with an error.  Zipf token data from
``repro_torch.data``; checkpoints under ``--ckpt-dir`` every
``--checkpoint-every`` steps.

``--mesh DATA,MODEL`` trains on a (data, model) device mesh (every
family), one process a rank, under ``torchrun``, which sets each
process's rank, the world size and the rendezvous address:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch tinyllama-1.1b --mesh 2,2 --steps 20 --seq-len 512 --batch 8

(NCCL, a card a rank by ``LOCAL_RANK``; with ``--device cpu``, gloo).
Every rank reads the same global batches; rank 0 prints.
"""
from __future__ import annotations

import argparse
import os

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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh, one process a "
                         "rank under torchrun")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     optimizer=args.optimizer, grad_accum=args.grad_accum,
                     checkpoint_every=args.checkpoint_every
                     if args.ckpt_dir else 0)
    mesh = _mesh(args.mesh, args.device) if args.mesh else None
    trainer = Trainer(cfg, tc, ckpt_dir=args.ckpt_dir, mesh=mesh,
                      device=args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    batch_size=args.batch)
    report = trainer.run(batches(dc), args.steps)
    if mesh is None or int(os.environ.get("RANK", 0)) == 0:
        print(f"device {trainer.model.device}"
              f"{f' mesh {args.mesh}' if mesh is not None else ''}: "
              f"steps={report.steps_done} loss {report.losses[0]:.3f} -> "
              f"{report.final_loss:.3f} retries={report.retries} "
              f"stragglers={report.straggler_steps}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def _mesh(spec: str, device):
    """The (data, model) mesh of ``--mesh``: the process group from
    torchrun's environment, NCCL with this rank's card current (gloo
    for ``--device cpu``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    data, model = (int(n) for n in spec.split(","))
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    return make_local_mesh(data, model, "cpu" if cpu else None)


if __name__ == "__main__":
    main()
