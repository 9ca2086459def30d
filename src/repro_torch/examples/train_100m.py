"""End-to-end training driver, the port's twin: a ~100M-parameter
llama-family model for a few hundred steps on synthetic data, with
checkpointing, crash-resume and the training metrics a production job
would emit.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]

The twin of the reference's ``examples/train_100m.py``, with its flags
and lines.  Without ``--device`` it runs on the CUDA device.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import DataConfig, batches
from repro_torch.train import Trainer


def model_100m() -> ModelConfig:
    # ~105M params: 12L d=768 12H GQA kv=4, llama-family
    return ModelConfig(
        name="llama-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
        vocab_size=32000, dtype="float32", attn_block_q=128,
        attn_block_k=128)


def run(steps: int = 300, seq_len: int = 256, batch: int = 8,
        device=None, cfg: Optional[ModelConfig] = None) -> List[str]:
    """The example's lines for ``steps`` optimizer steps of ``batch`` x
    ``seq_len`` tokens; ``cfg`` (default ``model_100m()``) lets a test
    train a narrower model."""
    cfg = cfg or model_100m()
    lines = [f"params: {cfg.param_count()/1e6:.0f}M"]
    tc = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                     total_steps=steps, checkpoint_every=100)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(cfg, tc, ckpt_dir=ckpt, device=device)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        batch_size=batch)
        report = trainer.run(batches(dc), steps)
        mean_ms = 1e3 * sum(report.step_times) / len(report.step_times)
        lines.append(f"steps={report.steps_done} "
                     f"loss {report.losses[0]:.3f} -> "
                     f"{report.final_loss:.3f} "
                     f"mean step {mean_ms:.0f}ms "
                     f"retries={report.retries}")
        assert report.final_loss < report.losses[0]
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    for line in run(args.steps, args.seq_len, args.batch, args.device):
        print(line)


if __name__ == "__main__":
    main()
