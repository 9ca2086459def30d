"""Decoder blocks of the dense and SSM families, pre-norm.

Torch counterpart of ``repro.models.blocks`` for ``family="dense"``
stacks (attention + SwiGLU) and ``family="ssm"`` stacks (Mamba-2 SSD, no
FFN when ``d_ff == 0``).  The reference groups layers into ``lax.scan``
steps; the port runs a Python loop over a list of per-layer parameter
dicts, so every step is one layer and there is no unrolled prefix.

Layer dict: ``{"ln1", "attn": {wq, wk, wv, wo} | "ssm": {in_proj, conv,
a_log, dt_bias, d_skip, norm, out_proj}[, "ln2", "ffn": {wi, wg, wo}]}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_rms, init_swiglu, rms_norm, swiglu


def step_layout(cfg: ModelConfig) -> Tuple[List[int], List[List[int]]]:
    """(prefix_layer_ids, steps): no prefix and one layer per step for the
    families this slice of the port runs, dense attention + SwiGLU and
    pure SSM."""
    ported = (cfg.moe is None and cfg.mla is None and cfg.hybrid is None
              and not cfg.inputs_embeds
              and (cfg.family == "dense" and cfg.ssm is None and cfg.d_ff > 0
                   or cfg.family == "ssm" and cfg.ssm is not None))
    if not ported:
        raise NotImplementedError(
            f"{cfg.name}: only plain dense attention + SwiGLU stacks and "
            f"pure SSM stacks are ported so far (family {cfg.family!r}; "
            f"ROADMAP.md queue 1, models off the main path)")
    return [], [[i] for i in range(cfg.n_layers)]


def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype, device) -> Dict:
    """Init one layer's params for its kind: attention or SSM with its
    norm, and SwiGLU with its norm when ``d_ff`` > 0."""
    p = {"ln1": init_rms(cfg.d_model, dtype, device)}
    if cfg.layer_kinds()[layer_idx] == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg.d_model, cfg.ssm, dtype, device)
    else:
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    if cfg.d_ff > 0:
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
        p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def apply_layer(p: Dict, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                mode: str, cache: Optional[Dict] = None, pos=None,
                proj: Optional[Dict] = None, max_len: int = 0,
                block_table: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None, num_splits: int = 1):
    """Returns ``(x, new_cache, captures)``.

    ``mode``: ``train`` (full-sequence causal attention with gradients:
    K6 under autograd; an SSM layer's forward with K7 under autograd),
    ``calibrate`` (captures q/k/v), ``prefill`` (builds a
    ``max_len`` cache), ``decode`` (one token per sequence at ``pos``,
    written into ``cache`` in place) or ``chunk`` (a prefill chunk
    starting at ``pos``, ``valid`` marking its real tokens, written into
    the paged ``cache`` in place).  ``block_table`` (B, n_pages) selects
    the paged cache in ``decode`` and is required in ``chunk``.  An SSM
    layer runs ``ssm_forward`` in ``prefill`` (returning its state) and
    ``calibrate`` (capturing nothing), and ``ssm_decode`` in ``decode``
    (its state updated in place); it has no paged cache and no chunks."""
    kind = cfg.layer_kinds()[layer_idx]
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    new_cache = captures = None
    if (block_table is not None or mode == "chunk") and kind != "attn":
        raise NotImplementedError(
            f"paged cache / chunked prefill supports plain attention "
            f"layers only (got {kind})")
    if mode not in ("train", "calibrate", "prefill", "decode", "chunk"):
        raise ValueError(f"unknown mode {mode!r}")
    if kind == "ssm":
        if mode in ("train", "calibrate"):
            y, _ = ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm)
        elif mode == "prefill":
            y, new_cache = ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm,
                                               return_state=True)
        else:
            y, new_cache = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg.ssm)
    elif mode == "train":
        y = attn_mod.attn_train(p["attn"], h, cfg)
    elif mode == "calibrate":
        y, captures = attn_mod.attn_calibrate(p["attn"], h, cfg)
    elif mode == "prefill":
        y, new_cache = attn_mod.attn_prefill(p["attn"], h, cfg, max_len,
                                             proj)
    elif mode == "decode":
        y, new_cache = attn_mod.attn_decode(p["attn"], h, cache, pos, cfg,
                                            proj, block_table, num_splits)
    else:
        y, new_cache = attn_mod.attn_prefill_chunk(
            p["attn"], h, cache, pos, cfg, proj, block_table, valid)
    x = x + y
    if "ffn" in p:
        x = x + swiglu(p["ffn"], rms_norm(x, p["ln2"], cfg.rms_eps))
    return x, new_cache, captures
