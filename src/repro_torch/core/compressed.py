"""Compressed-cache ops (torch) and size accounting.

The compressed cache stores, per attention layer and kv head,
``kc = K @ A_k`` (R dims) and ``vc = V @ A_v`` (Rv dims) instead of the
d-dimensional keys/values.  These helpers convert between representations
and account for bytes (the serving engine's ``capacity_gain``, the
projections' own weight bytes).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.calibration import ModelProjections


def compress_kv(k: torch.Tensor, v: torch.Tensor,
                a_k: torch.Tensor, a_v: torch.Tensor):
    """Project a full cache into the compressed representation.

    k, v: (B, Hkv, T, d); a_k: (Hkv, d, R); a_v: (Hkv, d, Rv).
    """
    kc = torch.einsum("bhtd,hdr->bhtr", k, a_k)
    vc = torch.einsum("bhtd,hdr->bhtr", v, a_v)
    return kc, vc


def compress_queries(q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """q: (B, H, T, d) -> (B, H, T, R) using the kv-group's B factor.

    b_q: (Hkv, d, R); query head j uses group j // (H // Hkv).
    """
    B, H, T, d = q.shape
    Hkv = b_q.shape[0]
    m = H // Hkv
    qg = q.reshape(B, Hkv, m, T, d)
    out = torch.einsum("bgmtd,gdr->bgmtr", qg, b_q)
    return out.reshape(B, H, T, -1)


@dataclass(frozen=True)
class CacheFootprint:
    """Bytes per token per layer, full vs compressed."""

    full_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        """Compressed bytes over full bytes."""
        return self.compressed_bytes / max(1, self.full_bytes)


def cache_footprint(n_kv_heads: int, d_head: int, rank_k: int, rank_v: int,
                    itemsize: int = 2) -> CacheFootprint:
    """Per-token, per-layer cache bytes of the full and compressed caches."""
    full = n_kv_heads * 2 * d_head * itemsize
    comp = n_kv_heads * (rank_k + rank_v) * itemsize
    return CacheFootprint(full, comp)


def projection_param_bytes(p: ModelProjections, itemsize: int = 2) -> int:
    """Bytes the solved projections take as weights: ``A_k`` and ``B_q``,
    and ``A_v`` and ``C_v`` where the value path is compressed."""
    total = p.a_k.size + p.b_q.size
    if p.a_v is not None:
        total += p.a_v.size + p.c_v.size
    return total * itemsize
