"""Compressed serving demo: method comparison on the same model, the
port's twin.

    PYTHONPATH=src python -m repro_torch.examples.serve_compressed \\
        --device cpu

The twin of the reference's ``examples/serve_compressed.py``, with its
lines: identical greedy requests served with the full cache and with
K-SVD / Eigen / KQ-SVD compressed caches at the same rank, reporting
agreement with the uncompressed output and the memory capacity gain.
Without ``--device`` it runs on the CUDA device.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.config import CompressionConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import GramAccumulator
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

METHODS = ("ksvd", "eigen", "kqsvd")


def run(device=None) -> List[str]:
    """The example's lines, in the reference's order and format."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)

    acc = GramAccumulator(len(model.attn_layers))
    rng = np.random.default_rng(10)
    for _ in range(4):
        toks = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        acc.update_from_captures(model.calibrate(params, toks))
    w_out = model.group_output_weights(params)

    prompt = (np.arange(12) * 5 % cfg.vocab_size).astype(np.int32)
    sc = ServeConfig(max_seq_len=48, max_batch=2)

    ref_eng = ServingEngine(cfg, params, sc, device=model.device)
    ref = [Request(rid=0, prompt=prompt, max_new_tokens=8)]
    ref_eng.generate(ref)
    lines = [f"{'full':8s}: {ref[0].out_tokens}"]

    R = cfg.d_head // 2
    for method in METHODS:
        mp = acc.solve(CompressionConfig(method=method, rank_k=R, rank_v=R),
                       w_out)
        eng = ServingEngine(cfg, params, sc, projections=mp,
                            device=model.device)
        reqs = [Request(rid=0, prompt=prompt, max_new_tokens=8)]
        eng.generate(reqs)
        agree = sum(a == b for a, b in zip(reqs[0].out_tokens,
                                           ref[0].out_tokens))
        lines.append(f"{method:8s}: {reqs[0].out_tokens}  "
                     f"agree {agree}/8  capacity x{eng.capacity_gain():.1f}")
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
