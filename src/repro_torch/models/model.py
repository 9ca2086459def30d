"""The language model: embed -> blocks -> norm -> head, in PyTorch.

Torch counterpart of ``repro.models.model.LM`` for the dense and the
SSM families.  Parameters are a plain dict of tensors on the model's
device:

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "layers": [layer dict, ...]}            (see ``blocks``)

which is the reference's pytree with its stacked ``steps`` unstacked into
a list (``repro_torch.bridge`` converts one into the other).  Caches are
lists with one dict per layer (an SSM layer's holds its conv tail and SSM
state), runtime projections lists with one dict per attention layer.

Public entry points:
    init(gen)                                   -> params
    prefill(params, batch, max_len, proj)       -> (logits, cache)
        (full-sequence attention in K6 on the card; a sliding window
        makes the cache a ring of min(max_len, window) slots; an SSM
        layer runs K7 and keeps only its state)
    decode_step(params, cache, tokens, pos, proj, block_table, num_splits)
                                                -> (logits, cache)
        (pos: per-sequence (B,) positions; scalars broadcast; the cache
        is updated in place and returned; a block table selects the
        paged cache, ``num_splits`` > 1 split-KV decoding over it)
    prefill_chunk(params, cache, tokens, pos0, valid, proj, block_table)
                                                -> (logits, cache)
        (one bucket-padded prompt chunk into the paged cache)
    calibrate(params, tokens)                   -> per-layer host captures
    group_output_weights(params)                -> stacked W^O per kv group

The model runs on ``torch.device("cuda")`` unless it is given another
device; with no device and no GPU it raises.  Logits are float32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import apply_layer, init_layer, step_layout
from repro_torch.models.layers import dtype_of, init_rms, rms_norm


class LM:
    """The language model: layer stack + embed/head, with prefill, decode
    and calibration entry points."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        step_layout(cfg)            # raises for families not ported yet
        self.kinds = cfg.layer_kinds()
        self.attn_layers = [i for i, k in enumerate(self.kinds)
                            if k in ("attn", "mla")]

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Init all parameters from ``gen``; the draws happen on the
        generator's device and the tensors land on the model's."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                            device=gen.device) * 0.02
        params: Dict[str, Any] = {
            "embed": embed.to(device=dev, dtype=dt),
            "final_norm": init_rms(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            head = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                               device=gen.device) / np.sqrt(cfg.d_model)
            params["lm_head"] = head.to(device=dev, dtype=dt)
        params["layers"] = [init_layer(gen, cfg, i, dt, dev)
                            for i in range(cfg.n_layers)]
        return params

    # -- embedding / head ----------------------------------------------------

    def _tokens(self, batch) -> torch.Tensor:
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x.float() @ head.float()

    def _run_stack(self, params, x, mode, cache=None, pos=None, proj=None,
                   max_len: int = 0, block_table=None, valid=None,
                   num_splits: int = 1):
        caches, captures, attn_ord = [], [], 0
        for i, lp in enumerate(params["layers"]):
            lproj = None
            if self.kinds[i] != "ssm":
                if proj is not None:
                    lproj = proj[attn_ord]
                attn_ord += 1
            x, nc, caps = apply_layer(
                lp, x, self.cfg, i, mode,
                cache[i] if cache is not None else None, pos, lproj,
                max_len, block_table, valid, num_splits)
            caches.append(nc)
            if caps is not None:
                captures.append(caps)
        return x, caches, captures

    # -- public entry points -------------------------------------------------

    def prefill(self, params, batch, max_len: int, proj=None):
        """Full-prompt prefill: last-token logits (B, 1, V) + a populated
        cache of length ``max_len``."""
        x = params["embed"][self._tokens(batch)]
        x, cache, _ = self._run_stack(params, x, "prefill", proj=proj,
                                      max_len=max_len)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x), cache

    def prefill_chunk(self, params, cache, tokens, pos0, valid, proj=None,
                      block_table=None):
        """One bucket-padded prompt chunk straight into a paged cache
        (reference ``LM.prefill_chunk``).

        tokens: (B, S) chunk whose first token sits at position
        ``pos0[b]``; ``valid``: (B, S) bool of real (non-padding) tokens,
        a contiguous prefix per row, or a (B,) count of them.  The chunk's
        (compressed) entries are written through ``block_table`` into the
        page pools in place; its queries attend the written pages.
        Returns logits (B, S, V) — rows past a sequence's last real token
        are garbage, so callers take the last real row — and ``cache``."""
        tokens = self._tokens(tokens)
        pos0 = attn_mod.batched_positions(pos0, tokens.shape[0], self.device)
        valid = torch.as_tensor(valid, device=self.device)
        x = params["embed"][tokens]
        x, cache, _ = self._run_stack(params, x, "chunk", cache=cache,
                                      pos=pos0, proj=proj,
                                      block_table=block_table, valid=valid)
        x = rms_norm(x, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x), cache

    def decode_step(self, params, cache, tokens, pos, proj=None,
                    block_table=None, num_splits: int = 1):
        """tokens: (B, 1); pos: (B,) index of each new token (a scalar
        broadcasts).  ``block_table``: (B, n_pages) int32, present iff
        ``cache`` is paged; ``num_splits`` > 1 splits each slot's page
        chain (split-KV decode).  Returns logits (B, 1, V) and ``cache``,
        updated in place."""
        tokens = self._tokens(tokens)
        pos = attn_mod.batched_positions(pos, tokens.shape[0], self.device)
        x = params["embed"][tokens]
        x, cache, _ = self._run_stack(params, x, "decode", cache=cache,
                                      pos=pos, proj=proj,
                                      block_table=block_table,
                                      num_splits=num_splits)
        x = rms_norm(x, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x), cache

    def calibrate(self, params, tokens) -> List[Dict[str, np.ndarray]]:
        """Per-attention-layer post-RoPE captures ``{"k", "q", "v"}`` as
        host float32 numpy arrays (``GramAccumulator.update`` takes host
        arrays); empty for an attention-free stack."""
        x = params["embed"][self._tokens(tokens)]
        _, _, captures = self._run_stack(params, x, "calibrate")
        return [{name: t.detach().float().cpu().numpy()
                 for name, t in cap.items()} for cap in captures]

    def group_output_weights(self, params) -> List[np.ndarray]:
        """Stacked per-group output weights for the value-path solve."""
        return [attn_mod.group_output_weights(params["layers"][i]["attn"],
                                              self.cfg)
                for i in self.attn_layers]

    # -- caches & projections ------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   ranks: Tuple[int, int] = (0, 0), dtype=None,
                   paged: bool = False) -> List[Dict[str, torch.Tensor]]:
        """Empty decode cache, one dict per layer; ``paged=True`` builds
        page-pool leaves from the configured page layout.  An SSM layer's
        dict is its zeroed state, ``{"conv": (batch, conv_dim, K-1)`` in
        the model dtype, ``"s": (batch, nh, d_state, head_dim)`` float32},
        whatever ``max_len``."""
        dtype = dtype or self.dtype
        return [ssm_mod.make_ssm_state(self.cfg.ssm, self.cfg.d_model, batch,
                                       dtype, self.device)
                if kind == "ssm" else
                attn_mod.make_attn_cache(self.cfg, batch, max_len, ranks,
                                         dtype, self.device, paged)
                for kind in self.kinds]

    def init_paged_cache(self, n_phys_pages: int, page_size: int,
                         ranks: Tuple[int, int] = (0, 0), dtype=None
                         ) -> List[Dict[str, torch.Tensor]]:
        """Page-pool cache, one dict per layer: every leaf is a pool
        ``(n_phys_pages, Hkv, page_size, width)`` read through a block
        table (reference ``LM.init_paged_cache``), i.e. ``init_cache``
        with (batch, max_len) read as (pages, page_size), its leaves those
        of the page layout ``cfg.cache_quant`` selects.  A sliding window
        raises ``NotImplementedError``, as in the reference: its ring
        cache lives on dense slots; so does a stack with non-attention
        layers."""
        kinds = set(self.kinds)
        if kinds != {"attn"}:
            raise NotImplementedError(
                f"paged cache supports plain attention stacks only "
                f"(layer kinds: {sorted(kinds)})")
        if self.cfg.sliding_window:
            raise NotImplementedError(
                "paged cache: sliding window not supported")
        return self.init_cache(n_phys_pages, page_size, ranks, dtype,
                               paged=True)

    def projections_pytree(self, mp, dtype=None
                           ) -> List[Dict[str, torch.Tensor]]:
        """Solved ``ModelProjections`` -> runtime projections: one dict of
        ``a_k``/``b_q``[/``a_v``/``c_v``] tensors per attention layer."""
        dtype = dtype or self.dtype
        arrays = {"a_k": mp.a_k, "b_q": mp.b_q}
        if mp.a_v is not None:
            arrays["a_v"] = mp.a_v
            arrays["c_v"] = mp.c_v
        return [{k: torch.as_tensor(np.asarray(v[i]), dtype=dtype,
                                    device=self.device)
                 for k, v in arrays.items()}
                for i in range(len(self.attn_layers))]


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> LM:
    """An ``LM`` for ``cfg`` on ``device`` (default: CUDA)."""
    return LM(cfg, device)
