"""AdamW with decoupled weight decay, global-norm clipping, and optional
reduced-precision moments.

Torch counterpart of ``repro.optim.adamw``, functional as the reference
is: ``apply_updates`` returns new params and a new state and writes into
neither, so a step that fails part-way leaves the old tree whole.  The
state mirrors the params: ``{"m", "v"}`` trees of the same structure,
and ``"step"``, a 0-d int32 tensor on the host.  Float32 math; results
cast back to each leaf's type.

Under a mesh the leaves are DTensors: every update is elementwise on the
shards, the state's moments are placed like their parameters, and the
clip's norm is the global one, over every shard (``global_norm``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import dtype_of
from repro_torch.sharding.partition import is_dtensor
from repro_torch.tree import leaves, tree_map, unflatten


def init_state(params, tc: TrainConfig) -> Dict[str, Any]:
    """Zero moments in ``tc.adam_dtype`` beside each parameter (placed
    like it, a DTensor's)."""
    mdt = dtype_of(tc.adam_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=mdt,
                                memory_format=torch.contiguous_format)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32.  DTensor leaves
    (sharded or replicated, never partial) count each element once: each
    rank sums its shards' squares, a shard held by r ranks weighted 1/r,
    and one all-reduce over the mesh adds the ranks' sums; the norm comes
    back as a plain tensor, the same on every rank."""
    plain, local, mesh = [], [], None
    for _, x in leaves(tree):
        if not is_dtensor(x):
            plain.append(x.float().square().sum())
            continue
        mesh = x.device_mesh
        reps = math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                         if pl.is_replicate())
        local.append(x.to_local().float().square().sum() / reps)
    if local:
        from torch.distributed.tensor import DTensor, Partial
        plain.append(DTensor.from_local(
            torch.stack(local).sum(), mesh,
            [Partial()] * mesh.ndim).full_tensor())
    return torch.stack(plain).sum().sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled to global norm at most ``max_norm``, and the norm
    before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


_DECAY_EXEMPT = ("ln1", "ln2", "norm", "final_norm", "a_log", "dt_bias",
                 "d_skip")


def _wd_mask(path) -> bool:
    """Weight decay applies unless the leaf's own name is a norm gain or
    an SSM decay / skip parameter."""
    return str(path[-1]) not in _DECAY_EXEMPT


def bias_corrections(step: torch.Tensor, *betas: float):
    """``1 - beta ** step`` for each beta, computed in float32 and handed
    back as Python floats holding those float32 values."""
    t = step.to(torch.float32)
    return [float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
            for b in betas]


@torch.no_grad()
def apply_updates(params, grads, state, tc: TrainConfig, lr: float
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new_params, new_state, {"grad_norm"})``."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state["step"] + 1
    b1, b2 = tc.beta1, tc.beta2
    bc1, bc2 = bias_corrections(step, b1, b2)
    new_p, new_m, new_v = [], [], []
    for (path, p), (_, g), (_, m), (_, v) in zip(
            leaves(params), leaves(grads), leaves(state["m"]),
            leaves(state["v"])):
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32 * g32 * (1 - b2)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + 1e-8)
        if tc.weight_decay and _wd_mask(path):
            update = update + tc.weight_decay * p.float()
        new_p.append((p.float() - lr * update).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    new_state = {"m": unflatten(params, new_m), "v": unflatten(params, new_v),
                 "step": step}
    return unflatten(params, new_p), new_state, {"grad_norm": gnorm}
