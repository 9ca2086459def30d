"""Abstract inputs and their shardings for a training step.

Torch counterpart of the training half of ``repro.launch.specs``: meta
tensors stand in for the reference's ``ShapeDtypeStruct`` (shapes and
types, no memory), and ``NamedSharding``s
(``repro_torch.sharding.partition``) for its ``NamedSharding``s:

* ``batch_specs(cfg, batch, seq, with_labels)``: one train / eval batch;
* ``batch_shardings(batch_tree, mesh)``: batch dim over the data axes;
* ``abstract_params(model)``: ``LM.init`` on the meta device;
* ``abstract_opt_state(params_abs, tc, layout)``: the optimizer state.

The decode half (caches, projections and their shardings) comes with the
port's dry run (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import optim
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import LM
from repro_torch.sharding.partition import axis_size, dp_axes, named
from repro_torch.tree import tree_map


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
