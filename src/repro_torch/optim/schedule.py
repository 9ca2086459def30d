"""LR schedule: linear warmup + cosine decay to 10%, in float32 as the
reference computes it (``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def learning_rate(tc: TrainConfig, step) -> float:
    """The learning rate at optimizer step ``step`` (an int or a 0-d
    tensor), as a Python float holding the float32 value."""
    s = torch.as_tensor(float(step), dtype=torch.float32)
    warm = torch.clamp((s + 1) / max(1, tc.warmup_steps), max=1.0)
    frac = torch.clamp((s - tc.warmup_steps)
                       / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return float(tc.learning_rate * warm * (0.1 + 0.9 * cos))
