"""Deterministic synthetic LM corpus (Zipf-distributed tokens).

The port's copy of the reference's numpy sampler: the same seed gives
the same tokens in both packages.

Stands in for C4 in this offline container: the KQ-SVD math is
data-agnostic (DESIGN.md §7), and the pipeline exposes the same interface
a file-backed token source would.  Sharding: each host reads a disjoint
index range (``host_id``/``n_hosts``); within a host the iterator yields
(global_batch/n_hosts, seq_len) int32 token blocks + next-token labels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int           # per-host batch
    seed: int = 0
    zipf_a: float = 1.2
    host_id: int = 0
    n_hosts: int = 1


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def sample_batch(cfg: DataConfig, index: int) -> Dict[str, np.ndarray]:
    """Deterministic batch ``index`` for this host (restart-stable)."""
    seed = (cfg.seed * 1_000_003 + index * 4099 + cfg.host_id) % (2**31)
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    toks = rng.choice(cfg.vocab_size, size=(cfg.batch_size,
                                            cfg.seq_len + 1), p=probs)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(cfg: DataConfig, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    i = start
    while True:
        yield sample_batch(cfg, i * cfg.n_hosts + cfg.host_id)
        i += 1


def calibration_batches(vocab: int, n_seqs: int, seq_len: int,
                        batch: int = 8, seed: int = 17):
    """The paper's calibration sampling (128 x 2048 by default)."""
    cfg = DataConfig(vocab_size=vocab, seq_len=seq_len, batch_size=batch,
                     seed=seed)
    out = []
    for i in range((n_seqs + batch - 1) // batch):
        out.append(sample_batch(cfg, i)["tokens"])
    return out
