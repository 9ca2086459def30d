"""Step functions of the port (shared by the trainer and the CLI).

Torch counterpart of ``repro.train.steps``.  ``make_train_step``: loss ->
grads (with optional gradient accumulation over microbatches, the
accumulator float32) -> clipped update.  Gradients come back in the
parameter type; the update is functional (``repro_torch.optim``).

Under a mesh (``Trainer(mesh=...)``) params, optimizer state and batch
are DTensors: autograd hands the gradients back as partial sums over the
data axes, and ``value_and_grad`` redistributes each to its parameter's
placements (the FSDP reduce-scatter, or the data-parallel all-reduce);
the metrics come back as plain tensors, the same on every rank.

``make_prefill_step`` / ``make_decode_step``: serving steps, full-cache
or KQ-SVD-compressed variants.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import optim
from repro_torch.config import TrainConfig
from repro_torch.models.model import LM
from repro_torch.optim.schedule import learning_rate
from repro_torch.sharding.partition import is_dtensor, placed_like, shard
from repro_torch.train.losses import total_loss
from repro_torch.tree import leaves, tree_map, unflatten


def make_loss_fn(model: LM, tc: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` (host arrays or tensors)."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch)
        labels = batch["labels"]
        if not is_dtensor(labels):
            labels = torch.as_tensor(labels, device=model.device)
        return total_loss(logits, labels, aux, tc, cfg.moe)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(metrics, grads)``: ``loss_fn``'s metrics (detached) and the
    gradient tree of its loss at ``params``, in the parameters' types
    (the caller's tensors are not marked: autograd runs on detached
    aliases of them).  A parameter the loss does not read (the token
    embeddings of a batch of frontend ``embeds``) gets a zero gradient,
    as ``jax.grad`` gives it.  A DTensor parameter's gradient is
    redistributed to the parameter's placements, and DTensor metrics are
    gathered into plain tensors."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves(live)],
                                allow_unused=True, materialize_grads=True)
    grads = [placed_like(g, p) for g, (_, p) in zip(grads, leaves(params))]
    metrics = {k: (v.full_tensor() if is_dtensor(v) else v).detach()
               for k, v in metrics.items()}
    return metrics, unflatten(params, grads)


def _microbatch(v, lo: int, hi: int):
    """Rows ``lo:hi`` of a batch leaf; a DTensor's sliced from the whole
    batch (the reference's microbatch i is rows i*mb .. (i+1)*mb of the
    global batch) and split over the data axes again."""
    mb = v[lo:hi]
    if is_dtensor(mb):
        mb = shard(mb, ("pod", "data"), *([None] * (mb.ndim - 1)))
    return mb


def accum_start(params, device):
    """The gradient accumulator before the first microbatch: float32
    zeros of each parameter's shape (a DTensor's placed like it) and the
    loss sum."""
    g_acc = tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)
    return g_acc, torch.zeros((), dtype=torch.float32, device=device)


def accum_microbatch(loss_fn, params, batch, i: int, n: int, acc):
    """The accumulation loop's body: microbatch ``i`` of ``n`` (rows
    ``i*mb .. (i+1)*mb`` of every batch leaf) added into ``acc`` in
    float32; returns the new accumulator.  Its gradients and metrics are
    freed when it returns, so every microbatch runs on the same live
    tensors, and issues the same operators on the same shapes (the first
    adds into zeros)."""
    g_acc, loss_sum = acc
    mb = {k: _microbatch(v, i * (len(v) // n), (i + 1) * (len(v) // n))
          for k, v in batch.items()}
    m, g = value_and_grad(loss_fn, params, mb)
    return (tree_map(lambda a, b: a + b.float(), g_acc, g),
            loss_sum + m["loss"])


def accum_finish(acc, params, n: int):
    """``(metrics, grads)`` of an accumulated step: the sum divided by
    ``n`` and cast to each parameter's type, and the mean loss."""
    g_acc, loss_sum = acc
    grads = tree_map(lambda g, p: (g / n).to(p.dtype), g_acc, params)
    return {"loss": loss_sum / n}, grads


def update_step(model: LM, tc: TrainConfig, params, opt_state, grads,
                metrics):
    """The step after the gradients: the scheduled learning rate, the
    clipped optimizer update, and the metrics with the optimizer's and
    ``lr``; returns ``(params, opt_state, metrics)``."""
    lr = learning_rate(tc, opt_state["step"])
    params, opt_state, om = optim.apply_updates(
        params, grads, opt_state, tc, lr, (model.prefix, model.steps))
    metrics = dict(metrics)
    metrics.update(om)
    metrics["lr"] = lr
    return params, opt_state, metrics


def make_train_step(model: LM, tc: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics ``loss`` (and ``ce``, ``tokens``, ``z_loss`` without
    accumulation), ``grad_norm`` and ``lr``.  With ``tc.grad_accum`` > 1
    the batch splits into that many microbatches on its leading axis,
    their gradients summed in float32 (a DTensor's accumulator placed
    like its parameter), divided and cast to the parameter type, as the
    reference's ``lax.scan`` does (``accum_start``, ``accum_microbatch``
    a microbatch, ``accum_finish``; then ``update_step``)."""
    loss_fn = make_loss_fn(model, tc)

    def train_step(params, opt_state, batch):
        n = tc.grad_accum
        if n > 1:
            acc = accum_start(params, model.device)
            for i in range(n):
                acc = accum_microbatch(loss_fn, params, batch, i, n, acc)
            metrics, grads = accum_finish(acc, params, n)
        else:
            metrics, grads = value_and_grad(loss_fn, params, batch)
        return update_step(model, tc, params, opt_state, grads, metrics)

    return train_step


def make_prefill_step(model: LM, max_len: int,
                      compressed: bool = False) -> Callable:
    """``prefill_step(params, batch)`` (or ``(params, proj, batch)``
    compressed) -> ``(logits, cache)``."""
    if compressed:
        def prefill_step_c(params, proj, batch):
            return model.prefill(params, batch, max_len, proj=proj)
        return prefill_step_c

    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: LM, compressed: bool = False) -> Callable:
    """``decode_step(params, cache, tokens, pos)`` (or ``(params, proj,
    cache, tokens, pos)`` compressed) -> ``(logits, cache)``."""
    if compressed:
        def decode_step_c(params, proj, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos, proj=proj)
        return decode_step_c

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step
