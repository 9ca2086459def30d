"""Shared neural layers: RMSNorm, SwiGLU, rotary embeddings, init.

Torch counterparts of ``repro.models.layers`` with the same arithmetic:
f32 statistics in RMSNorm, rotate-half RoPE from a float64 frequency
ladder cast to f32, and the fused SwiGLU ``h * sigmoid(g) * g``.  The
init functions draw from an explicit ``torch.Generator``; they cannot
reproduce ``jax.random`` streams, so parity tests bridge the reference's
parameters instead (``repro_torch.bridge``).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a ModelConfig.dtype name."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis (fp32 statistics, input dtype out)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * gain.float()).to(x.dtype)


def init_rms(d: int, dtype, device) -> torch.Tensor:
    """Unit gain vector for ``rms_norm``."""
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama rotate-half convention)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    """(d_head/2,) inverse-frequency ladder for rotary embeddings."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


@functools.lru_cache(maxsize=16)
def _inv_freq(d_head: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """``rope_frequencies`` as f32 on ``device``, copied there once (a
    host-to-device copy per call would stall the stream every layer).
    Built outside any fake mode, so that a dry run's first call caches a
    real table, not a fake one."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.as_tensor(rope_frequencies(d_head, theta),
                               dtype=torch.float32).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, d) with positions broadcastable to (..., T) — e.g.
    (T,) for a shared sequence or (B, 1, 1) for per-sequence decode."""
    d = x.shape[-1]
    freqs = _inv_freq(d, float(theta), x.device)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., T, d/2)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def swiglu(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``wo @ (silu(wg x) * wi x)``."""
    h = x @ params["wi"]
    g = x @ params["wg"]
    # silu(g) * h == h * g * sigmoid(g), in the reference's order
    h = h * torch.sigmoid(g.float()).to(h.dtype) * g
    return h @ params["wo"]


def init_dense(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int,
               dtype, device) -> torch.Tensor:
    """Gaussian init scaled by ``1/sqrt(fan_in)``, drawn from ``gen``."""
    w = torch.randn(shape, generator=gen, device=gen.device) / np.sqrt(fan_in)
    return w.to(device=device, dtype=dtype)


def init_swiglu(gen: torch.Generator, d: int, ff: int, dtype,
                device) -> Dict[str, torch.Tensor]:
    """Fan-in scaled gaussian init for the three SwiGLU matrices."""
    return {
        "wi": init_dense(gen, (d, ff), d, dtype, device),
        "wg": init_dense(gen, (d, ff), d, dtype, device),
        "wo": init_dense(gen, (ff, d), ff, dtype, device),
    }
