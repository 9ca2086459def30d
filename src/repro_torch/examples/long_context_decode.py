"""Long-context decode on the sub-quadratic archs (reduced configs).

    PYTHONPATH=src python -m repro_torch.examples.long_context_decode \\
        --device cpu

The port's twin of the reference's ``examples/long_context_decode.py``:
the decode-state scaling story behind the long-context shape, from the
bytes of the caches ``LM.init_cache`` builds at T = 256 and 1024:

* mamba2  — O(1) state regardless of context;
* jamba   — O(T) only on its 1-in-4 (reduced; 1-in-8 at full size)
  attention layers, beside the SSM state of the others;
* danube  — O(window) ring cache under the sliding window;

and, for the attention caches, the KQ-SVD compressed variant (ranks
``d_head // 2``), then one real decode step each.  Without ``--device``
it runs on the CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b", "h2o-danube-1.8b")
LENGTHS = (256, 1024)


def cache_bytes(cache) -> int:
    """Bytes of every leaf of a per-layer cache list."""
    return sum(t.numel() * t.element_size()
               for layer in cache for t in layer.values())


def reduced(arch: str):
    """The arch's reduced config, MoE made dropless as the reference's
    example makes it."""
    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def cache_sizes(arch: str, device="cpu") -> Dict[int, Tuple[int, int]]:
    """``{T: (full cache bytes, KQ-SVD cache bytes or 0)}`` for one
    sequence of the reduced arch (0: attention-free, nothing to
    compress)."""
    cfg = reduced(arch)
    model = build_model(cfg, device)
    out = {}
    for T in LENGTHS:
        full = cache_bytes(model.init_cache(1, T))
        kq = 0
        if not cfg.attention_free:
            r = max(1, cfg.d_head // 2)
            kq = cache_bytes(model.init_cache(1, T, (r, r)))
        out[T] = (full, kq)
    return out


def run(device=None) -> List[str]:
    """The example's lines: cache bytes per arch and length, then one
    decode step per arch at position 512 of a 1024-token cache."""
    lines = []
    for arch in ARCHS:
        cfg = reduced(arch)
        model = build_model(cfg, device)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(0)
        params = model.init(gen)
        for T, (full, kq) in cache_sizes(arch, model.device).items():
            line = f"{arch:24s} T={T:5d}: cache {full:9d} B"
            if not cfg.attention_free:
                line += f"  kqsvd {kq:9d} B"
            lines.append(line)
        cache = model.init_cache(1, 1024)
        tok = torch.zeros((1, 1), dtype=torch.long, device=model.device)
        logits, _ = model.decode_step(params, cache, tok, 512)
        assert bool(torch.isfinite(logits).all()), arch
        lines.append(f"{arch:24s} decode step OK, logits "
                     f"{tuple(logits.shape)}")
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
