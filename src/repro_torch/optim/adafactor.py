"""Adafactor (Shazeer & Stern, 2018): factored second moments.

Torch counterpart of ``repro.optim.adafactor``.  Factoring applies to the
trailing two dims of >=2-D parameters; 1-D parameters fall back to full
second moments.  Update clipping (RMS threshold 1.0) and decoupled weight
decay follow the paper.

The reference's parameters are stacked over its scan steps (leaves
``(n_steps, ...)`` under ``steps/layers/j``, ``j`` the position in a
step: one position in a homogeneous stack, eight in Jamba's hybrid
period), and its statistics are those of the stacked leaf: a norm gain
``(n_steps, d)`` is factored, and the RMS clip is taken over all steps
of a leaf at once.  The port holds one dict per layer, so this module
stacks the layer leaves by name and position (``tree.stack_layers``,
over the model's ``layout``: ``models.blocks.step_layout``), updates the
stacked leaves exactly as the reference does, and unstacks the result:
per-layer statistics would give other numbers.  Leading
layers of another structure (DeepSeek-V2's dense first layer) are the
reference's unrolled prefix and keep per-layer statistics under
``prefix``.  The state keeps that layout: ``{"slots": the stacked
params' tree with a slot {"vr", "vc", "m"} or {"v", "m"} at each leaf,
"step"}``, the reference's own slot shapes.  Functional, as the
reference is: new params and a new state, the old ones untouched.

Under a mesh the leaves are DTensors: the stacking keeps each leaf's
placements (a stacked shard is the stack of the layers' shards), the row
and column statistics reduce over sharded dims through DTensor, and each
new slot keeps the placement its old one had (``params_shardings``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.optim.adamw import _wd_mask, clip_by_global_norm
from repro_torch.sharding.partition import placed_like
from repro_torch.tree import (Layout, leaves, stack_layers, tree_map,
                              unflatten, unstack_layers)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _slot(shape, device) -> Dict[str, torch.Tensor]:
    shape = tuple(shape)

    def zeros(s, dt=torch.float32):
        return torch.zeros(s, dtype=dt, device=device)
    if _factored(shape):
        return {"vr": zeros(shape[:-1]),
                "vc": zeros(shape[:-2] + shape[-1:]),
                "m": zeros(shape, torch.bfloat16)}
    return {"v": zeros(shape), "m": zeros(shape, torch.bfloat16)}


def init_state(params, tc: TrainConfig, layout: Optional[Layout] = None
               ) -> Dict[str, Any]:
    """Zero slots for the stacked layout of ``params`` (shapes only: the
    stacking runs on the meta device); ``layout`` is the model's
    ``(prefix, steps)``, needed where ``params`` has a layer list."""
    meta = stack_layers(tree_map(
        lambda p: torch.empty(p.shape, device="meta"), params), layout)
    dev = leaves(params)[0][1].device
    return {"slots": tree_map(lambda p: _slot(p.shape, dev), meta),
            "step": torch.zeros((), dtype=torch.int32)}


def _slot_at(slots, path):
    for key in path:
        slots = slots[key]
    return slots


@torch.no_grad()
def apply_updates(params, grads, state, tc: TrainConfig, lr: float,
                  layout: Optional[Layout] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One Adafactor step over the stacked layout (``layout`` as in
    ``init_state``): ``(new_params, new_state, {"grad_norm"})``."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = float(1.0 - t ** -0.8)                  # paper's schedule
    eps = 1e-30
    sp, sg = stack_layers(params, layout), stack_layers(grads, layout)
    new_p, new_slots = [], []
    for (path, p), (_, g) in zip(leaves(sp), leaves(sg)):
        slot = _slot_at(state["slots"], path)
        g32 = g.float()
        g2 = g32 * g32 + eps
        if "vr" in slot:
            vr = beta2 * slot["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * slot["vc"] + (1 - beta2) * g2.mean(-2)
            denom = vr.mean(-1, keepdim=True)
            precond = (vr / denom.clamp_min(eps))[..., None] \
                * vc[..., None, :]
            update = g32 * torch.rsqrt(precond.clamp_min(eps))
            new_slot = {"vr": vr, "vc": vc}
        else:
            v = beta2 * slot["v"] + (1 - beta2) * g2
            update = g32 * torch.rsqrt(v.clamp_min(eps))
            new_slot = {"v": v}
        # update clipping at RMS threshold 1.0
        rms = torch.sqrt((update * update).mean() + eps)
        update = update / rms.clamp_min(1.0)
        m = tc.beta1 * slot["m"].float() + (1 - tc.beta1) * update
        new_slot["m"] = m.to(torch.bfloat16)
        if tc.weight_decay and _wd_mask(path):
            m = m + tc.weight_decay * p.float()
        new_p.append((p.float() - lr * m).to(p.dtype))
        new_slots.append({k: placed_like(v, slot[k])
                          for k, v in new_slot.items()})
    new_params = unstack_layers(unflatten(sp, new_p), layout)
    return new_params, {"slots": unflatten(sp, new_slots), "step": step}, \
        {"grad_norm": gnorm}
