"""Decoder blocks of the dense family: attention + SwiGLU, pre-norm.

Torch counterpart of ``repro.models.blocks`` for ``family="dense"``
stacks.  The reference groups layers into ``lax.scan`` steps; the port
runs a Python loop over a list of per-layer parameter dicts, so every
step is one layer and there is no unrolled prefix.

Layer dict: ``{"ln1", "attn": {wq, wk, wv, wo}, "ln2", "ffn": {wi, wg, wo}}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import init_rms, init_swiglu, rms_norm, swiglu


def step_layout(cfg: ModelConfig) -> Tuple[List[int], List[List[int]]]:
    """(prefix_layer_ids, steps): no prefix and one layer per step for the
    dense family, the only one this slice of the port runs."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.mla is not None \
            or cfg.ssm is not None or cfg.hybrid is not None \
            or cfg.inputs_embeds or cfg.d_ff <= 0:
        raise NotImplementedError(
            f"{cfg.name}: only plain dense attention + SwiGLU stacks are "
            f"ported so far (family {cfg.family!r}; ROADMAP.md queue 1, "
            f"models off the main path)")
    return [], [[i] for i in range(cfg.n_layers)]


def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype, device) -> Dict:
    """Init one layer's params: attention and SwiGLU with their norms."""
    del layer_idx                       # every dense layer is alike
    return {"ln1": init_rms(cfg.d_model, dtype, device),
            "attn": attn_mod.init_attention(gen, cfg, dtype, device),
            "ln2": init_rms(cfg.d_model, dtype, device),
            "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def apply_layer(p: Dict, x: torch.Tensor, cfg: ModelConfig, mode: str,
                cache: Optional[Dict] = None, pos=None,
                proj: Optional[Dict] = None, max_len: int = 0,
                block_table: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None, num_splits: int = 1):
    """Returns ``(x, new_cache, captures)``.

    ``mode``: ``calibrate`` (captures q/k/v), ``prefill`` (builds a
    ``max_len`` cache), ``decode`` (one token per sequence at ``pos``,
    written into ``cache`` in place) or ``chunk`` (a prefill chunk
    starting at ``pos``, ``valid`` marking its real tokens, written into
    the paged ``cache`` in place).  ``block_table`` (B, n_pages) selects
    the paged cache in ``decode`` and is required in ``chunk``."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    new_cache = captures = None
    if mode == "calibrate":
        y, captures = attn_mod.attn_calibrate(p["attn"], h, cfg)
    elif mode == "prefill":
        y, new_cache = attn_mod.attn_prefill(p["attn"], h, cfg, max_len,
                                             proj)
    elif mode == "decode":
        y, new_cache = attn_mod.attn_decode(p["attn"], h, cache, pos, cfg,
                                            proj, block_table, num_splits)
    elif mode == "chunk":
        y, new_cache = attn_mod.attn_prefill_chunk(
            p["attn"], h, cache, pos, cfg, proj, block_table, valid)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + y
    x = x + swiglu(p["ffn"], rms_norm(x, p["ln2"], cfg.rms_eps))
    return x, new_cache, captures
