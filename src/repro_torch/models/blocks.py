"""Decoder blocks of every family, pre-norm.

Torch counterpart of ``repro.models.blocks``: a mixer (attention, MLA or
a Mamba-2 SSD layer) and an FFN (SwiGLU, or a mixture of experts), each
behind its RMSNorm.  The reference groups layers into ``lax.scan`` steps
behind an unrolled prefix of heterogeneous leading layers (DeepSeek-V2's
dense first layer), one hybrid period a step (Jamba's seven SSM layers
and one attention layer); the port runs a Python loop over a list of
per-layer parameter dicts, the prefix layers first.  ``step_layout``
gives the reference's grouping, which the bridge and Adafactor's stacked
statistics follow.

Layer dict: ``{"ln1", "attn": {wq, wk, wv, wo} | MLA {wq, wd, wuk, wuv,
wo} | "ssm": {in_proj, conv, a_log, dt_bias, d_skip, norm, out_proj}[,
"ln2", "ffn": {wi, wg, wo} | MoE {router, wi_e, wg_e, wo_e[, shared][,
residual]}]}``.  The FFN is absent when ``d_ff == 0`` and the layer is
not MoE (pure Mamba-2).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_rms, init_swiglu, rms_norm, swiglu
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.sharding.partition import shard


def step_layout(cfg: ModelConfig) -> Tuple[List[int], List[List[int]]]:
    """(prefix_layer_ids, steps), each step a list of layer ids: the
    ``first_k_dense`` layers of a MoE stack form the unrolled prefix, as
    in the reference, and the other layers go into steps of one hybrid
    period each (one layer without ``cfg.hybrid``).  The reference also
    asserts that the steps are whole periods of one structure, which its
    ``lax.scan`` needs; the port's loop does not, so a stack cut short of
    a period (a hybrid model at a reduced depth) ends in a shorter
    step."""
    prefix = []
    if cfg.moe is not None and cfg.moe.first_k_dense:
        prefix = list(range(cfg.moe.first_k_dense))
    body = [i for i in range(cfg.n_layers) if i not in prefix]
    period = cfg.hybrid.period if cfg.hybrid is not None else 1
    return prefix, [body[i: i + period] for i in range(0, len(body), period)]


def attn_sublayer_index(cfg: ModelConfig, step: List[int]) -> Optional[int]:
    """Index within ``step`` of its one attention or MLA layer, None if
    it has none."""
    idxs = [j for j, i in enumerate(step)
            if cfg.layer_kinds()[i] in ("attn", "mla")]
    if len(idxs) > 1:
        raise ValueError(f"{cfg.name}: more than one attention layer in "
                         f"the step {step}")
    return idxs[0] if idxs else None


def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype, device) -> Dict:
    """Init one layer's params for its kind: attention, MLA or SSM with
    its norm, then a MoE FFN or a SwiGLU (``first_dense_ff`` wide in a
    MoE stack's leading dense layers) with its norm, unless the layer has
    no FFN."""
    kind = cfg.layer_kinds()[layer_idx]
    fk = cfg.ffn_kind(layer_idx)
    p: Dict[str, Any] = {"ln1": init_rms(cfg.d_model, dtype, device)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg.d_model, cfg.ssm, dtype, device)
    elif kind == "mla":
        p["attn"] = mla_mod.init_mla(gen, cfg, dtype, device)
    else:
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, device)
    if fk == "moe" or cfg.d_ff > 0:
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
        if fk == "moe":
            p["ffn"] = init_moe(gen, cfg.d_model, cfg.moe, dtype, device)
        else:
            ff = cfg.d_ff
            if cfg.moe is not None and layer_idx < cfg.moe.first_k_dense:
                ff = cfg.moe.first_dense_ff or cfg.d_ff
            p["ffn"] = init_swiglu(gen, cfg.d_model, ff, dtype, device)
    return p


def _ffn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
               mode: str, token_mask: Optional[torch.Tensor] = None):
    """Post-mixer FFN with its residual: ``(x, aux)``, aux the MoE
    router's statistics (empty for a SwiGLU or no FFN).  ``token_mask``
    (decode and chunk modes only) as ``apply_layer`` takes it."""
    if "ffn" not in p:
        return x, {}
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.ffn_kind(layer_idx) != "moe":
        return x + swiglu(p["ffn"], h), {}
    if token_mask is not None and token_mask.ndim == 1:
        # the count form of a budget-truncated chunk: MoE routing takes
        # the expanded per-token prefix mask
        token_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                      < token_mask[:, None])
    y, aux = moe_ffn(p["ffn"], h, cfg.moe, mode, token_mask=token_mask)
    return x + y, aux


def apply_layer(p: Dict, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                mode: str, cache: Optional[Dict] = None, pos=None,
                proj: Optional[Dict] = None, max_len: int = 0,
                block_table: Optional[torch.Tensor] = None,
                token_mask: Optional[torch.Tensor] = None,
                num_splits: int = 1):
    """Returns ``(x, new_cache, captures, aux)``.

    ``mode``: ``train`` (full-sequence causal attention with gradients:
    K6 under autograd; an SSM layer's forward with K7 under autograd),
    ``calibrate`` (captures q/k/v; MLA's latent as k/v), ``prefill``
    (builds a ``max_len`` cache), ``decode`` (one token per sequence at
    ``pos``, written into ``cache`` in place) or ``chunk`` (a prefill
    chunk starting at ``pos``, written into the paged ``cache`` in
    place).  ``token_mask`` marks live tokens: in ``decode`` the (B, 1)
    live slots, in ``chunk`` the chunk's real tokens, (B, S) bool or a
    (B,) count of them (a budget-truncated chunk), which the attention
    takes as it is and MoE routing as the expanded prefix mask, so dead
    slots and padding take no expert capacity.  ``block_table`` (B,
    n_pages) selects the paged cache in ``decode`` and is required in
    ``chunk``; both belong to attention layers only, as in the reference.
    An SSM layer runs ``ssm_forward`` in ``prefill`` (returning its state)
    and ``calibrate`` (capturing nothing), and ``ssm_decode`` in
    ``decode`` (its state updated in place).  ``aux`` holds a MoE layer's
    router statistics, else nothing."""
    kind = cfg.layer_kinds()[layer_idx]
    x = shard(x, ("pod", "data"), None, None)
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
    elif kind == "mla":
        if mode == "train":
            y = mla_mod.mla_train(p["attn"], h, cfg)
        elif mode == "calibrate":
            y, captures = mla_mod.mla_calibrate(p["attn"], h, cfg)
        elif mode == "prefill":
            y, new_cache = mla_mod.mla_prefill(p["attn"], h, cfg, max_len,
                                               proj)
        else:
            y, new_cache = mla_mod.mla_decode(p["attn"], h, cache, pos, cfg,
                                              proj)
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
            p["attn"], h, cache, pos, cfg, proj, block_table, token_mask)
    # on a mesh the mixer's output projection leaves a partial sum over
    # the model axis, which DTensor would reduce-scatter onto the sequence
    # for the norm; the FFN's (B S, D) rows would then carry a strided
    # shard its products cannot propagate (the production meshes' prefill
    # and training), so the sum is all-reduced here, the batch kept on the
    # data axes (a no-op without a mesh)
    x = shard(x + y, ("pod", "data"), None, None)
    x, aux = _ffn_apply(p, x, cfg, layer_idx, mode,
                        token_mask if mode in ("decode", "chunk") else None)
    return x, new_cache, captures, aux


def init_layer_cache(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, ranks: Tuple[int, int], dtype, device,
                     paged: bool = False) -> Dict[str, torch.Tensor]:
    """Empty decode-cache dict for one layer: attention (``paged``: the
    pool leaves of the configured page layout), MLA's (B, T, R) leaves,
    or an SSM layer's zeroed state."""
    kind = cfg.layer_kinds()[layer_idx]
    if kind == "attn":
        return attn_mod.make_attn_cache(cfg, batch, max_len, ranks, dtype,
                                        device, paged)
    if kind == "mla":
        return mla_mod.make_mla_cache(cfg, batch, max_len, ranks, dtype,
                                      device)
    return ssm_mod.make_ssm_state(cfg.ssm, cfg.d_model, batch, dtype,
                                  device)
