"""The language model: embed -> blocks -> norm -> head, in PyTorch.

Torch counterpart of ``repro.models.model.LM`` for every family: dense,
SSM, MoE, MLA, the hybrid (SSM layers around one attention layer a
period) and the audio / VLM stubs.  Parameters are a plain dict of
tensors on the model's device:

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "layers": [layer dict, ...]}            (see ``blocks``)

which is the reference's pytree with its unrolled ``prefix`` layers first
and its stacked ``steps`` unstacked after them, one list in layer order
(``repro_torch.bridge`` converts one into the other).  Caches are lists
with one dict per layer (an SSM layer's holds its conv tail and SSM
state, an MLA layer's its (B, T, R) latent and rope keys), runtime
projections lists with one dict per attention or MLA layer (a hybrid
stack's attention layers only).

A batch is a (B, S) token array, or a dict of ``tokens`` (B, S) or the
stub frontend's ``embeds`` (B, S, D), either with ``image_embeds`` (B, P,
D) put ahead of them (``_embed``, the reference's): ``prefill``,
``train_logits`` and ``calibrate`` take it, so a VLM prefill's cache and
logits cover the P + S positions.  ``prefill_chunk`` and ``decode_step``
take tokens only, as in the reference.

Public entry points:
    init(gen)                                   -> params
    prefill(params, batch, max_len, proj)       -> (logits, cache)
        (full-sequence attention in K6 on the card, MLA's at (192, 128);
        a sliding window makes the cache a ring of min(max_len, window)
        slots; an SSM layer runs K7 and keeps only its state; a VLM
        prefix of P patches takes P of the ``max_len`` positions)
    decode_step(params, cache, tokens, pos, proj, block_table,
                token_mask, num_splits)         -> (logits, cache)
        (pos: per-sequence (B,) positions; scalars broadcast; the cache
        is updated in place and returned; a block table selects the
        paged cache, ``num_splits`` > 1 split-KV decoding over it;
        ``token_mask`` (B,) live slots, the only ones MoE routing counts)
    prefill_chunk(params, cache, tokens, pos0, valid, proj, block_table)
                                                -> (logits, cache)
        (one bucket-padded prompt chunk into the paged cache)
    train_logits(params, batch)                 -> (logits, aux)
        (full-sequence logits with gradients: K6 and K7 under autograd,
        each layer rematerialized in the backward as ``cfg.remat_policy``
        says; aux sums the MoE layers' router statistics, ``n_moe``
        counts those layers)
    calibrate(params, batch, host=True)         -> per-layer captures
        (host numpy arrays; ``host=False`` keeps them on the device;
        the patch positions of a VLM batch are captured too)
    group_output_weights(params)                -> stacked W^O per kv group

The model runs on ``torch.device("cuda")`` unless it is given another
device; with no device and no GPU it raises.  Logits are float32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models.blocks import (apply_layer, attn_sublayer_index,
                                       init_layer, init_layer_cache,
                                       step_layout)
from repro_torch.models.layers import dtype_of, init_rms, rms_norm
from repro_torch.sharding.partition import gather_dp, is_dtensor, shard
from repro_torch.tree import tree_map


AUX_KEYS = ("load_balance", "router_z", "dropped_frac")
# matrix products whose outputs the "dots" remat policy keeps (the
# reference's ``dots_saveable``); everything else is recomputed
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    """The reference's aux sums at zero (``n_moe`` counts MoE layers)."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS + ("n_moe",)}


def _add_aux(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """``acc`` plus one layer's router statistics; a layer without a
    router adds nothing, and ``acc`` stays empty until one has (no zeros
    are made on the device for a stack without MoE)."""
    if not aux:
        return acc
    if not acc:
        acc = _zero_aux(aux["load_balance"].device)
    out = {k: acc[k] + aux[k] if k in aux else acc[k] for k in AUX_KEYS}
    out["n_moe"] = acc["n_moe"] + (1.0 if "load_balance" in aux else 0.0)
    return out


def _lookup_sharded(weight, tokens):
    """``weight[tokens]`` for DTensors, through ``local_map``: DTensor's
    rules for the index ops (and their backward) are not dependable
    across torch versions.  Each rank looks its batch rows' tokens up in
    the vocabulary rows it holds (the rules shard the vocabulary over the
    model axis, after ``gather_dp``), zeros where another rank holds the
    row, and the ranks' partial sums add up over that axis; the rows'
    gradients come back partial over the axes that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, wp, tp = weight.device_mesh, weight.placements, tokens.placements
    coord = mesh.get_coordinate()
    v0 = 0
    for i, pl in enumerate(wp):
        if pl == Shard(0):
            v0 = v0 * mesh.size(i) + coord[i]
    v0 *= weight.to_local().shape[0]
    out_pl = [Partial() if w == Shard(0) else t for w, t in zip(wp, tp)]
    grad_pl = [w if w == Shard(0) else Partial() if t == Shard(0)
               else Replicate() for w, t in zip(wp, tp)]

    def lookup(w, t, v0):
        rows = t - v0
        hit = (rows >= 0) & (rows < w.shape[0])
        x = w[rows.clamp(0, w.shape[0] - 1)]
        return torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(wp, tp, None),
                     in_grad_placements=(grad_pl, tp, None),
                     device_mesh=mesh)(weight, tokens, v0)


def _dots_policy(ctx, op, *args, **kwargs):
    policies = torch_checkpoint.CheckpointPolicy
    return (policies.MUST_SAVE if op in _DOT_OPS
            else policies.PREFER_RECOMPUTE)


def remat_options(policy: str) -> Dict[str, Any]:
    """``torch.utils.checkpoint`` options for ``cfg.remat_policy``, one
    checkpoint per layer as the reference's ``jax.checkpoint`` wraps each
    scan step; None for ``"none"`` (no remat).  ``"nothing"`` and
    ``"full"`` (and any other name, as in the reference) recompute the
    whole layer; ``"dots"`` keeps the matrix products' outputs through
    torch's selective-checkpoint policy."""
    if policy == "none":
        return None
    opts = {"use_reentrant": False, "preserve_rng_state": False}
    if policy == "dots":
        opts["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return opts


class LM:
    """The language model: layer stack + embed/head, with prefill, decode
    and calibration entry points."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.prefix, self.steps = step_layout(cfg)
        for step in self.steps:     # at most one attention layer a step
            attn_sublayer_index(cfg, step)
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

    def _embed(self, params, batch) -> torch.Tensor:
        """The stack's input (B, S', D) in the model type: the token
        embeddings, or the stub frontend's ``embeds`` in their place, with
        ``image_embeds`` (B, P, D) put first when the batch has them
        (S' = P + S).  A bare array is a token batch."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        if "embeds" in batch:
            x = torch.as_tensor(batch["embeds"], device=self.device) \
                .to(self.dtype)
        elif is_dtensor(params["embed"]):
            x = _lookup_sharded(params["embed"], self._tokens(batch))
        else:
            x = params["embed"][self._tokens(batch)]
        if "image_embeds" in batch:
            img = torch.as_tensor(batch["image_embeds"], device=self.device)
            x = torch.cat([img.to(self.dtype), x], dim=1)
        return shard(x, ("pod", "data"), None, None)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return shard(x.float() @ head.float(), ("pod", "data"), None,
                     "model")

    def _run_stack(self, params, x, mode, cache=None, pos=None, proj=None,
                   max_len: int = 0, block_table=None, token_mask=None,
                   num_splits: int = 1):
        """Every layer in order: ``(x, caches, captures, aux)``, aux the
        MoE layers' summed router statistics (empty without MoE)."""
        caches, captures, attn_ord = [], [], 0
        aux: Dict[str, torch.Tensor] = {}
        sharded = is_dtensor(params["embed"])
        for i, lp in enumerate(params["layers"]):
            if sharded:             # FSDP's gather at use, a layer at a time
                lp = tree_map(gather_dp, lp)
            lproj = None
            if self.kinds[i] != "ssm":
                if proj is not None:
                    lproj = proj[attn_ord]
                attn_ord += 1
            x, nc, caps, la = apply_layer(
                lp, x, self.cfg, i, mode,
                cache[i] if cache is not None else None, pos, lproj,
                max_len, block_table, token_mask, num_splits)
            caches.append(nc)
            if caps is not None:
                captures.append(caps)
            aux = _add_aux(aux, la)
        return x, caches, captures, aux

    # -- public entry points -------------------------------------------------

    def prefill(self, params, batch, max_len: int, proj=None):
        """Full-prompt prefill: last-token logits (B, 1, V) + a populated
        cache of length ``max_len``; ``batch`` as ``_embed`` takes it.  On
        DTensor params (a mesh) the cache comes out under
        ``launch.specs.cache_shardings``, ``seq_sharded`` for a batch of
        one."""
        top = self._top(params)
        x = self._embed(top, batch)
        x, cache, _, _ = self._run_stack(params, x, "prefill", proj=proj,
                                         max_len=max_len)
        x = rms_norm(x[:, -1:], top["final_norm"], self.cfg.rms_eps)
        return self._logits(top, x), cache

    @staticmethod
    def _top(params):
        """The params outside the layers, gathered over the data axes
        (FSDP's gather at use) where they are DTensors."""
        return {k: gather_dp(v) for k, v in params.items() if k != "layers"}

    def prefill_chunk(self, params, cache, tokens, pos0, valid, proj=None,
                      block_table=None):
        """One bucket-padded prompt chunk straight into a paged cache
        (reference ``LM.prefill_chunk``).

        tokens: (B, S) chunk whose first token sits at position
        ``pos0[b]``; ``valid``: (B, S) bool of real (non-padding) tokens,
        a contiguous prefix per row, or a (B,) count of them, which is
        also the token mask of MoE routing (padding takes no expert
        capacity).  The chunk's (compressed) entries are written through
        ``block_table`` into the page pools in place; its queries attend
        the written pages.
        Returns logits (B, S, V) — rows past a sequence's last real token
        are garbage, so callers take the last real row — and ``cache``."""
        tokens = self._tokens(tokens)
        pos0 = attn_mod.batched_positions(pos0, tokens.shape[0], self.device)
        valid = torch.as_tensor(valid, device=self.device)
        x = params["embed"][tokens]
        x, cache, _, _ = self._run_stack(params, x, "chunk", cache=cache,
                                         pos=pos0, proj=proj,
                                         block_table=block_table,
                                         token_mask=valid)
        x = rms_norm(x, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x), cache

    def decode_step(self, params, cache, tokens, pos, proj=None,
                    block_table=None, token_mask=None, num_splits: int = 1):
        """tokens: (B, 1); pos: (B,) index of each new token (a scalar
        broadcasts).  ``block_table``: (B, n_pages) int32, present iff
        ``cache`` is paged; ``token_mask``: (B,) bool of live slots, the
        only ones MoE routing gives expert capacity; ``num_splits`` > 1
        splits each slot's page chain (split-KV decode).  Returns logits
        (B, 1, V) and ``cache``, updated in place.  On DTensor params (a
        mesh) the cache is the dense one placed by
        ``launch.specs.cache_shardings``, and so are the updates."""
        top = self._top(params)
        tokens = self._tokens(tokens)
        pos = attn_mod.batched_positions(pos, tokens.shape[0], self.device)
        x = self._embed(top, tokens)
        tm = (torch.as_tensor(token_mask, device=self.device)[:, None]
              if token_mask is not None else None)
        x, cache, _, _ = self._run_stack(params, x, "decode", cache=cache,
                                         pos=pos, proj=proj,
                                         block_table=block_table,
                                         token_mask=tm,
                                         num_splits=num_splits)
        x = rms_norm(x, top["final_norm"], self.cfg.rms_eps)
        return self._logits(top, x), cache

    def train_logits(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (B, S, V) float32 and the aux sums (the
        MoE layers' router statistics, summed, and ``n_moe``; zero for a
        stack without MoE), differentiable in ``params``: attention and
        MLA run K6 and an SSM layer K7 under autograd.  Each layer is
        checkpointed as ``cfg.remat_policy`` says (``remat_options``);
        remat changes no number.  ``batch`` as ``_embed`` takes it: with
        ``image_embeds`` the logits cover the P + S positions, and a
        train batch's labels are -100 (ignored) over the patches."""
        top = self._top(params)
        x = self._embed(top, batch)
        opts = remat_options(self.cfg.remat_policy)
        aux: Dict[str, torch.Tensor] = {}
        for i, lp in enumerate(params["layers"]):
            if opts is None:
                x, la = self._train_layer(lp, x, i)
            else:
                x, la = torch_checkpoint.checkpoint(self._train_layer, lp, x,
                                                    i, **opts)
            aux = _add_aux(aux, la)
        x = rms_norm(x, top["final_norm"], self.cfg.rms_eps)
        return self._logits(top, x), aux or _zero_aux(self.device)

    def _train_layer(self, lp, x, i):
        x, _, _, aux = apply_layer(tree_map(gather_dp, lp), x, self.cfg, i,
                                   "train")
        return x, aux

    def calibrate(self, params, batch, host: bool = True) -> List[Dict]:
        """Per-attention-layer post-RoPE captures ``{"k", "q", "v"}`` (an
        MLA layer's latent as k and v with one kv head, its absorbed
        queries as q) over every position of ``batch`` (as ``_embed``
        takes it: a VLM batch's patches too): host float32 numpy arrays
        (``GramAccumulator.update`` takes host arrays), or with
        ``host=False`` the tensors on the model's device, in the model's
        type (``make_calibrate_step`` sums their Grams there); empty for
        an attention-free stack, one per attention layer of a hybrid."""
        x = self._embed(params, batch)
        _, _, captures, _ = self._run_stack(params, x, "calibrate")
        if not host:
            return captures
        return [{name: t.detach().float().cpu().numpy()
                 for name, t in cap.items()} for cap in captures]

    def group_output_weights(self, params) -> List[np.ndarray]:
        """Stacked per-group output weights for the value-path solve: W^O
        per kv group, an MLA layer's absorbed ``W_uv W_o`` (1, lora,
        H*D)."""
        return [(mla_mod.mla_group_output_weights
                 if self.kinds[i] == "mla" else
                 attn_mod.group_output_weights)(params["layers"][i]["attn"],
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
        whatever ``max_len``; an MLA layer's its (batch, max_len, R)
        latent (``c``, or ``cc``/``ccv`` at the KQ-SVD ranks) and rope
        keys ``kr``."""
        dtype = dtype or self.dtype
        return [init_layer_cache(self.cfg, i, batch, max_len, ranks, dtype,
                                 self.device, paged)
                for i in range(self.cfg.n_layers)]

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
        layers (SSM, MLA, a hybrid's SSM layers)."""
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
        ``a_k``/``b_q``[/``a_v``/``c_v``] tensors per attention or MLA
        layer, in layer order."""
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
