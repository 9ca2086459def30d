"""Abstract inputs and their shardings for training and serving steps.

Torch counterpart of ``repro.launch.specs``: meta tensors stand in for
the reference's ``ShapeDtypeStruct`` (shapes and types, no memory), and
``NamedSharding``s (``repro_torch.sharding.partition``) for its
``NamedSharding``s:

* ``batch_specs(cfg, batch, seq, with_labels)``: one train / eval batch;
* ``batch_shardings(batch_tree, mesh)``: batch dim over the data axes;
* ``abstract_params(model)``: ``LM.init`` on the meta device;
* ``abstract_opt_state(params_abs, tc, layout)``: the optimizer state;
* ``abstract_cache(model, batch, max_len, ranks)`` and
  ``cache_shardings(cache, mesh, seq_sharded=...)``: the decode cache,
  batch on the data axes, the model axis on kv heads where they divide
  it and otherwise on the sequence (sequence-parallel decode);
* ``default_ranks(cfg)``, ``abstract_projections(model, ranks)`` and
  ``projection_shardings(proj, mesh)``: the KQ-SVD factors;
* ``replicated(mesh)`` / ``tree_replicated(tree, mesh)``.

The port's cache is a list of per-layer dicts and its projections a list
of per-attention-layer dicts (the reference stacks its scanned layers
under a leading dim, which its rules skip: here that offset is 0).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.blocks import init_layer_cache
from repro_torch.models.model import LM
from repro_torch.sharding.partition import (axis_size, dp_axes, mesh_axes,
                                            named)
from repro_torch.tree import leaves, tree_map, unflatten


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                with_labels: bool) -> Dict[str, Any]:
    """Meta tensors for one training/eval batch of the cell: token ids or
    embeddings, optional image patches, optional labels (patch tokens
    extend the label length)."""
    out: Dict[str, Any] = {}
    label_len = seq
    if cfg.inputs_embeds:
        out["embeds"] = _meta((batch, seq, cfg.d_model), dtype_of(cfg.dtype))
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    if cfg.num_patch_tokens:
        out["image_embeds"] = _meta((batch, cfg.num_patch_tokens,
                                     cfg.d_model), dtype_of(cfg.dtype))
        label_len = seq + cfg.num_patch_tokens
    if with_labels:
        out["labels"] = _meta((batch, label_len), torch.int32)
    return out


def batch_shardings(batch_tree, mesh) -> Dict[str, Any]:
    """``NamedSharding``s for a batch tree: leading (batch) dim split over
    the mesh's data axes when divisible, everything else replicated."""
    dp = dp_axes(mesh)
    dpsize = axis_size(dp, mesh)

    def spec(leaf):
        parts = [None] * len(leaf.shape)
        if leaf.shape and leaf.shape[0] % dpsize == 0 and dpsize > 1:
            parts[0] = dp
        return named(mesh, *parts)

    return tree_map(spec, batch_tree)


# ---------------------------------------------------------------------------
# Params / optimizer state
# ---------------------------------------------------------------------------


def abstract_params(model: LM):
    """The parameter tree as meta tensors (no memory): ``model.init``
    traced under a fake-tensor mode, every leaf's shape and type."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init(torch.Generator())
    return tree_map(lambda t: _meta(t.shape, t.dtype), params)


def abstract_opt_state(params_abs, tc: TrainConfig, layout=None):
    """The optimizer state as meta tensors, matching ``optim.init_state``
    over the abstract params (``layout``: the model's ``(prefix, steps)``,
    which Adafactor's stacked statistics need); the step counter is the
    host's 0-d tensor, as ``init_state`` makes it."""
    return optim.init_state(params_abs, tc, layout)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def abstract_cache(model: LM, batch: int, max_len: int,
                   ranks: Tuple[int, int]) -> List[Dict[str, Any]]:
    """The decode cache as meta tensors at the given batch, capacity and
    compression ranks ((0, 0) = full cache): ``LM.init_cache``'s leaves,
    one dict a layer."""
    return [init_layer_cache(model.cfg, i, batch, max_len, ranks,
                             model.dtype, "meta")
            for i in range(model.cfg.n_layers)]


_SEQ_AXIS_BY_LEAF = {
    # leaf name -> (batch, kvhead, seq dims) in the layer cache
    "k": (0, 1, 2), "v": (0, 1, 2),
    "kc": (0, 1, 2), "vc": (0, 1, 2),
    "kscale": (0, 1, 2), "vscale": (0, 1, 2),
    "c": (0, None, 1), "cc": (0, None, 1), "ccv": (0, None, 1),
    "kr": (0, None, 1),
}


def cache_spec(name: str, shape: Tuple[int, ...], mesh, *,
               seq_sharded: bool) -> Tuple[Any, ...]:
    """The spec of one cache leaf (the reference's ``cache_shardings``
    rule).  Batch on the data axes; the model axis on kv heads when they
    divide it, otherwise on the sequence (FlashDecoding-style sequence
    parallelism: each rank attends its span and the spans merge by their
    log-sum-exp); with ``seq_sharded`` (B = 1, long context) the data
    axes go on the sequence too.  An SSM layer's ``conv`` and ``s`` take
    heads (channels) on the model axis; MLA's latent leaves have no head
    dim, so their sequence takes it.  Anything else (a ring's
    ``slot_pos``) is replicated."""
    dp = dp_axes(mesh)
    dpsize = axis_size(dp, mesh)
    msize = mesh_axes(mesh).get("model", 1)
    nd = len(shape)
    parts: List[Any] = [None] * nd
    if name in _SEQ_AXIS_BY_LEAF:
        b_dim, h_dim, s_dim = _SEQ_AXIS_BY_LEAF[name]
        heads_shardable = (h_dim is not None and msize > 1
                           and shape[h_dim] % msize == 0)
        seq_axes: List[str] = []
        if seq_sharded and dpsize > 1:
            seq_axes.extend(dp)
        if not heads_shardable and msize > 1:
            seq_axes.append("model")
        if heads_shardable:
            parts[h_dim] = "model"
        if not seq_sharded and dpsize > 1 and shape[b_dim] % dpsize == 0:
            parts[b_dim] = dp
        if seq_axes and shape[s_dim] % axis_size(tuple(seq_axes),
                                                 mesh) == 0:
            parts[s_dim] = tuple(seq_axes)
    elif name == "conv":                                  # (B, Cd, K-1)
        if not seq_sharded and shape[-3] % dpsize == 0 and dpsize > 1:
            parts[-3] = dp
        if shape[-2] % msize == 0 and msize > 1:
            parts[-2] = "model"
    elif name == "s":                                     # (B, nh, n, hd)
        if not seq_sharded and shape[-4] % dpsize == 0 and dpsize > 1:
            parts[-4] = dp
        if shape[-3] % msize == 0 and msize > 1:
            parts[-3] = "model"
    return tuple(parts)


def cache_shardings(cache_tree, mesh, *, seq_sharded: bool):
    """``NamedSharding``s for a cache tree (tensors or meta tensors), one a
    leaf, by ``cache_spec`` on the leaf's name."""
    return unflatten(cache_tree, [
        named(mesh, *cache_spec(str(path[-1]), tuple(leaf.shape), mesh,
                                seq_sharded=seq_sharded))
        for path, leaf in leaves(cache_tree)])


# ---------------------------------------------------------------------------
# Projections (the paper's factors) as abstract inputs
# ---------------------------------------------------------------------------


def default_ranks(cfg: ModelConfig) -> Tuple[int, int]:
    """Representative compressed ranks (about eps = 0.1): half the head
    dim; an MLA latent (one shared latent stored as both K and V, against
    two compressed factors) takes a quarter of ``kv_lora_rank`` a path,
    for a 2x cache saving."""
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank // 4
        return r, r
    return max(1, cfg.d_head // 2), max(1, cfg.d_head // 2)


def abstract_projections(model: LM, ranks: Tuple[int, int]
                         ) -> List[Dict[str, torch.Tensor]]:
    """Meta tensors matching ``LM.projections_pytree``: one dict of
    ``a_k`` / ``b_q`` / ``a_v`` / ``c_v`` a attention or MLA layer, in
    layer order."""
    cfg = model.cfg
    rk, rv = ranks
    dt = model.dtype
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_model

    def layer_spec(kind):
        if kind == "mla":
            lora = cfg.mla.kv_lora_rank
            return {"a_k": _meta((1, lora, rk), dt),
                    "b_q": _meta((1, lora, rk), dt),
                    "a_v": _meta((1, lora, rv), dt),
                    "c_v": _meta((1, rv, H * D), dt)}
        dh = cfg.d_head
        return {"a_k": _meta((Hkv, dh, rk), dt),
                "b_q": _meta((Hkv, dh, rk), dt),
                "a_v": _meta((Hkv, dh, rv), dt),
                "c_v": _meta((Hkv, rv, H // Hkv * D), dt)}

    return [layer_spec(model.kinds[i]) for i in model.attn_layers]


def projection_spec(shape: Tuple[int, ...], mesh) -> Tuple[Any, ...]:
    """The spec of a KQ-SVD factor: its kv-head dim (-3 on every factor
    kind) on the model axis when it divides it, else replicated."""
    msize = mesh_axes(mesh).get("model", 1)
    parts: List[Any] = [None] * len(shape)
    if len(shape) >= 3 and shape[-3] % msize == 0 and msize > 1:
        parts[-3] = "model"
    return tuple(parts)


def projection_shardings(proj_tree, mesh):
    """``NamedSharding``s for a projections tree, by
    ``projection_spec``."""
    return tree_map(lambda t: named(mesh, *projection_spec(tuple(t.shape),
                                                           mesh)),
                    proj_tree)


# ---------------------------------------------------------------------------
# Replication
# ---------------------------------------------------------------------------


def replicated(mesh):
    """The fully replicated ``NamedSharding`` on ``mesh``."""
    return named(mesh)


def tree_replicated(tree, mesh):
    """Every leaf of ``tree`` replicated on ``mesh``."""
    return tree_map(lambda _: replicated(mesh), tree)
