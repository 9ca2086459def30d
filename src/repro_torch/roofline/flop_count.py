"""FLOP count of the port's own steps.

Torch counterpart of ``repro.roofline.hlo_cost``.  The reference walks
the optimized XLA HLO text of a compiled step and multiplies ``while``
bodies by their trip counts, because ``compiled.cost_analysis()`` counts
a scanned body once.  The port emits no HLO: its steps are eager
PyTorch, and a Python loop over the layers runs every layer's
operations.  So this module runs a step once under
``torch.utils.flop_counter.FlopCounterMode`` and reads the count:

* ``"train"``: the loss of ``LM.train_logits`` and its gradient
  (``train.steps.value_and_grad`` of ``make_loss_fn``), forward and
  backward, and under a ``remat_policy`` the forward each layer's
  checkpoint recomputes;
* ``"prefill"``: ``LM.prefill`` of a token batch
  (``train.steps.make_prefill_step``);
* ``"decode"``: one ``LM.decode_step`` over a fresh cache of ``max_len``
  positions (``train.steps.make_decode_step``).

The counter sees matrix products (``mm``, ``bmm``, ``addmm``,
``baddbmm``, convolutions, SDPA) at two FLOPs a multiply-add, and
nothing element-wise: ``flops`` equals ``dot_flops``, and the
reference's ``transcendentals`` and ``bytes`` have no counterpart here.

CPU only.  On CPU tensors every kernel's wrapper runs its plain PyTorch
version, whose products the counter sees; on the card the Hopper kernels
are ctypes launches it cannot see, so a model on any other device raises
``ValueError``.  The plain versions compute the whole score matrix
(causal masking discards half of it, and a decode step scores every
position of its cache), so the count is what the plain versions do, not
the least the step needs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import TrainConfig
from repro_torch.train.steps import (make_decode_step, make_loss_fn,
                                     make_prefill_step, value_and_grad)

KINDS = ("train", "prefill", "decode")


@dataclass
class CostTotals:
    """A step's counted FLOPs (the reference's field names where they
    mean the same): ``flops`` and ``dot_flops`` (equal: only matrix
    products are counted), ``by_op`` the FLOPs per aten operator."""
    flops: float = 0.0
    dot_flops: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)


def count_step_flops(model, params, kind: str, tokens: np.ndarray,
                     projections=None, max_len: int = 0) -> CostTotals:
    """Count one ``kind`` step of ``model`` (an ``LM`` on the CPU) at
    ``params``.  ``tokens``: (B, S) int32, the batch of a train or
    prefill step (its own labels in training), or (B, 1) the tokens of a
    decode step at the last position of its cache.  ``projections``:
    solved ``ModelProjections`` for the compressed prefill and decode.
    ``max_len``: the prefill's cache length (default S) or the decode
    cache's."""
    if model.device.type != "cpu":
        raise ValueError(
            f"count_step_flops counts the plain PyTorch versions on the "
            f"CPU; on {model.device} the kernels are launches the counter "
            f"cannot see")
    if kind not in KINDS:
        raise ValueError(f"unknown step kind {kind!r} (known: {KINDS})")
    tokens = np.asarray(tokens, np.int32)
    proj = (model.projections_pytree(projections)
            if projections is not None else None)
    if kind == "train":
        loss_fn = make_loss_fn(model, TrainConfig())

        def run():
            value_and_grad(loss_fn, params,
                           {"tokens": tokens, "labels": tokens})
    elif kind == "prefill":
        step = make_prefill_step(model, max_len or tokens.shape[1],
                                 compressed=proj is not None)
        args = (params, proj, tokens) if proj is not None \
            else (params, tokens)

        def run():
            step(*args)
    else:
        ranks = ((projections.rank_k, projections.rank_v)
                 if projections is not None else (0, 0))
        cache = model.init_cache(tokens.shape[0], max_len, ranks)
        step = make_decode_step(model, compressed=proj is not None)
        pos = max_len - 1
        args = ((params, proj, cache, tokens, pos) if proj is not None
                else (params, cache, tokens, pos))

        def run():
            step(*args)
    return count_flops(run)


def count_flops(fn: Callable[[], object]) -> CostTotals:
    """Run ``fn()`` once under ``FlopCounterMode`` and return its
    count."""
    with FlopCounterMode(display=False) as counter:
        fn()
    total = float(counter.get_total_flops())
    by_op = {str(op): float(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return CostTotals(flops=total, dot_flops=total, by_op=by_op)
