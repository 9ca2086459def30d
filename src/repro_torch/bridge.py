"""Bring the reference package's parameters into the port.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so the parity tests build parameters with the reference's
``LM.init`` and convert them here.  The caller turns the JAX arrays into
numpy first (``jax.tree.map(np.asarray, params)``): this module imports
neither ``jax`` nor anything of the reference package.

Reference layout (``repro/models/model.py:76-106``): ``embed``,
``final_norm``, optional ``lm_head``, a ``prefix`` list of unrolled
layers and ``steps = {"layers": (layer, ...)}`` whose leaves are stacked
on a leading step axis.  Port layout (``repro_torch.models.model``): the
same top-level tensors and ``layers``, a list with one dict per layer,
the prefix layers first.
``opt_state_from_jax`` brings the reference's AdamW and Adafactor states
across the same way, so a train step can start from one state in both
packages.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.calibration import ModelProjections

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (float32, bfloat16 or float16) as a tensor of the
    same type on ``device``."""
    a = np.asarray(a)
    dtype = _DTYPES[a.dtype.name]
    return torch.as_tensor(a.astype(np.float32)).to(device=device,
                                                    dtype=dtype)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def _layers(jparams: Dict[str, Any], device) -> list:
    """The reference's ``prefix`` layers, then its stacked ``steps``
    unstacked in layer order: step ``i``, position ``j`` of a step of
    ``P`` layers is layer ``i·P + j`` after the prefix."""
    step_layers = jparams["steps"]["layers"]
    n = np.asarray(step_layers[0]["ln1"]).shape[0]
    prefix = [_tree(layer, lambda a: to_tensor(a, device))
              for layer in jparams.get("prefix") or []]
    return prefix + [_tree(stacked, lambda a, i=i: to_tensor(
        np.asarray(a)[i], device))
        for i in range(n) for stacked in step_layers]


def params_from_jax(jparams: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The reference's ``LM.init`` pytree (as numpy) -> the port's params:
    the unrolled ``prefix`` layers (DeepSeek-V2's dense first layer) come
    first in ``layers``, then the layers of the scan steps in order (a
    hybrid step holds a whole period)."""
    out = {k: to_tensor(jparams[k], device)
           for k in ("embed", "final_norm", "lm_head") if k in jparams}
    out["layers"] = _layers(jparams, device)
    return out


def projections_from_jax(mp) -> ModelProjections:
    """The reference's solved ``ModelProjections`` -> the port's (the
    same float64 arrays and per-layer ranks), ready for
    ``LM.projections_pytree``."""
    def arr(a):
        return None if a is None else np.asarray(a, np.float64)
    return ModelProjections(a_k=arr(mp.a_k), b_q=arr(mp.b_q),
                            a_v=arr(mp.a_v), c_v=arr(mp.c_v),
                            ranks_k=list(mp.ranks_k),
                            ranks_v=list(mp.ranks_v), method=mp.method)


def opt_state_from_jax(jstate: Dict[str, Any], device="cpu"
                       ) -> Dict[str, Any]:
    """The reference's optimizer state (as numpy) -> the port's.

    AdamW ``{"m", "v", "step"}``: the moment trees mirror the params and
    unstack as ``params_from_jax`` does.  Adafactor ``{"slots", "step"}``:
    the port keeps the reference's stacked layout
    (``repro_torch.optim.adafactor``), so the slots of ``steps/layers``
    become ``slots["layers"]`` as they are, stacked, one dict per
    position of a step, and the unrolled prefix layers' slots
    ``slots["prefix"]``, one dict a layer."""
    step = torch.tensor(int(np.asarray(jstate["step"])), dtype=torch.int32)
    if "slots" not in jstate:
        return {"m": params_from_jax(jstate["m"], device),
                "v": params_from_jax(jstate["v"], device), "step": step}
    slots = jstate["slots"]
    out = {k: _tree(slots[k], lambda a: to_tensor(a, device))
           for k in ("embed", "final_norm", "lm_head") if k in slots}
    if slots.get("prefix"):
        out["prefix"] = [_tree(layer, lambda a: to_tensor(a, device))
                         for layer in slots["prefix"]]
    out["layers"] = [_tree(layer, lambda a: to_tensor(a, device))
                     for layer in slots["steps"]["layers"]]
    return {"slots": out, "step": step}
