"""Architecture registry of the port.

Each module defines ``config() -> ModelConfig`` with the same numbers as
the reference's module of the same name.  The port carries the
dense-family configs, h2o-danube-1.8b's sliding window included, and
the SSM family's mamba2-2.7b; the other families come with their slices
(ROADMAP.md queue 1, models off the main path).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    # sliding window 4096: the ring cache and K6's window branch
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    # the paper's own evaluation model
    "paper-llama2-7b": "paper_llama2_7b",
    # attention-free SSM (Mamba-2 SSD): K7 under every prefill
    "mamba2-2.7b": "mamba2_2_7b",
}

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    """The ``ModelConfig`` of arch ``name``; raises ``KeyError`` for an
    arch this slice of the port does not carry."""
    if name not in _cache:
        if name not in _ARCH_MODULES:
            raise KeyError(
                f"unknown arch {name!r} for the port; ported so far: "
                f"{sorted(_ARCH_MODULES)}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[name]}")
        _cache[name] = mod.config()
    return _cache[name]


def list_archs() -> List[str]:
    """Arch ids the port carries."""
    return list(_ARCH_MODULES)
