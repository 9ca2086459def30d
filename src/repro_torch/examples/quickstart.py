"""Quickstart: the whole KQ-SVD lifecycle, the port's twin.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The twin of the reference's ``examples/quickstart.py``, with its lines:

1. train a small llama-family model on synthetic data,
2. calibrate K/Q/V Gram statistics (the paper's 128x2048 protocol,
   scaled down),
3. solve the closed-form KQ-SVD projections (Thm 2) at eps=0.1,
4. serve with the compressed cache and compare against the full cache.

Without ``--device`` it runs on the CUDA device.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.config import CompressionConfig, ServeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_model
from repro_torch.core.compressed import cache_footprint
from repro_torch.data import DataConfig, batches, calibration_batches
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import Trainer


def run(device=None) -> List[str]:
    """The example's lines, in the reference's order and format."""
    lines = []
    cfg = get_config("tinyllama-1.1b").reduced()
    lines.append(f"model: {cfg.name}  layers={cfg.n_layers} "
                 f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}")

    # 1. train briefly
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=30,
                     checkpoint_every=0)
    trainer = Trainer(cfg, tc, device=device)
    report = trainer.run(
        batches(DataConfig(cfg.vocab_size, seq_len=64, batch_size=4)), 30)
    lines.append(f"trained 30 steps: loss {report.losses[0]:.3f} -> "
                 f"{report.final_loss:.3f}")
    params = trainer.state["params"]
    model = trainer.model

    # 2 + 3. calibrate and solve KQ-SVD projections
    calib = calibration_batches(cfg.vocab_size, n_seqs=8, seq_len=64,
                                batch=4)
    proj = calibrate_model(model, params, calib,
                           CompressionConfig(method="kqsvd", epsilon=0.1))
    fp = cache_footprint(cfg.n_kv_heads, cfg.d_head, proj.rank_k,
                         proj.rank_v)
    lines.append(f"KQ-SVD ranks per layer: k={proj.ranks_k} "
                 f"v={proj.ranks_v}")
    lines.append(f"cache bytes/token/layer: {fp.full_bytes} -> "
                 f"{fp.compressed_bytes} ({1/fp.ratio:.2f}x more sequences "
                 f"per HBM)")

    # 4. serve, compressed vs full
    prompt = np.arange(12, dtype=np.int32) % cfg.vocab_size
    for label, p in [("full cache ", None), ("kqsvd cache", proj)]:
        eng = ServingEngine(cfg, params,
                            ServeConfig(max_seq_len=64, max_batch=2),
                            projections=p, device=model.device)
        reqs = [Request(rid=0, prompt=prompt, max_new_tokens=8)]
        eng.generate(reqs)
        lines.append(f"{label}: {reqs[0].out_tokens}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    for line in run(args.device):
        print(line)


if __name__ == "__main__":
    main()
