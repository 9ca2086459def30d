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
same top-level tensors and ``layers``, a list with one dict per layer.
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


def params_from_jax(jparams: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The reference's ``LM.init`` pytree (as numpy) -> the port's params.

    Only dense stacks: no unrolled prefix, one layer per scan step."""
    if jparams.get("prefix"):
        raise NotImplementedError("unrolled prefix layers belong to "
                                  "non-dense families, not ported yet")
    step_layers = jparams["steps"]["layers"]
    if len(step_layers) != 1:
        raise NotImplementedError("multi-layer scan steps (hybrid stacks) "
                                  "are not ported yet")
    stacked = step_layers[0]
    n = np.asarray(stacked["ln1"]).shape[0]
    out = {k: to_tensor(jparams[k], device)
           for k in ("embed", "final_norm", "lm_head") if k in jparams}
    out["layers"] = [_tree(stacked, lambda a, i=i: to_tensor(
        np.asarray(a)[i], device)) for i in range(n)]
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
