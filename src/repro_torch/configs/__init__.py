"""Architecture registry of the port.

Each module defines ``config() -> ModelConfig`` with the same numbers as
the reference's module of the same name.  The port carries every config
of the reference: the dense family (h2o-danube-1.8b's sliding window
included), the SSM family's mamba2-2.7b, the MLA + MoE family's
deepseek-v2-lite-16b, the MoE family's arctic-480b, the hybrid
jamba-1.5-large-398b and the audio / VLM stubs musicgen-large and
phi-3-vision-4.2b.  deepseek-67b (about 134 GB in bf16) runs reduced
only on one card; arctic-480b (about 960 GB) and jamba-1.5-large-398b
(about 800 GB) at full width with their depth cut.
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
    # 15 query / 5 kv heads (m = 3), tied embeddings: the trained model
    "smollm-360m": "smollm_360m",
    # d_head 128, 95 layers
    "deepseek-67b": "deepseek_67b",
    # attention-free SSM (Mamba-2 SSD): K7 under every prefill
    "mamba2-2.7b": "mamba2_2_7b",
    # MLA (latent cache, absorbed decode) + MoE with shared experts and a
    # dense first layer: K6 at (192, 128)
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    # 128 experts top-2 beside a dense residual FFN; 56 query heads
    # padded to 64 (m 8): K1, K2, K5 on pages
    "arctic-480b": "arctic_480b",
    # hybrid: Mamba-2 SSD layers (K7) with one GQA attention layer in
    # each period of 8, MoE every 2nd layer
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    # stub frontends: frame embeddings in place of tokens (MHA, d_head
    # 64), patch embeddings ahead of the text (MHA, d_head 96)
    "musicgen-large": "musicgen_large",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    """The ``ModelConfig`` of arch ``name``; raises ``KeyError`` for an
    unknown arch."""
    if name not in _cache:
        if name not in _ARCH_MODULES:
            raise KeyError(
                f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[name]}")
        _cache[name] = mod.config()
    return _cache[name]


def list_archs() -> List[str]:
    """Arch ids the port carries."""
    return list(_ARCH_MODULES)
