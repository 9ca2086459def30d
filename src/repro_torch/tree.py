"""Nested dicts and lists of tensors: the port's pytrees.

The port's parameters, optimizer states and checkpoints are plain nested
dicts and lists (``models.model`` documents the parameter layout).  These
helpers walk them by path, the way the reference walks its JAX pytrees:

    leaves(tree)              -> [(path, leaf), ...] in a fixed order
    unflatten(template, vals) -> template's structure, vals as its leaves
    tree_map(fn, tree, *rest) -> the same structure, fn on each leaf
    path_key(path)            -> "layers/0/attn/wq" (checkpoint keys)
    stack_layers(params, layout)
                              -> "layers" as the reference's stacked steps
                                 (a heterogeneous "prefix" apart)
    unstack_layers(st, layout) -> back to a list of per-layer dicts

``layout`` is the model's ``(prefix layer ids, steps)``
(``models.blocks.step_layout``).  ``stack_layers`` gives the reference's
own layout of a stack (its ``steps/layers/j`` leaves carry a leading step
axis, its unrolled ``prefix`` layers do not), which is what Adafactor's
statistics and update clip are taken over.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

Path = Tuple[Any, ...]
SEP = "/"


def leaves(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs, dict keys in insertion order, list items in
    order; a leaf is anything that is not a dict, list or tuple."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves(v, path + (i,))]
    return [(path, tree)]


def unflatten(template, values: Sequence):
    """``template``'s structure with ``values`` as its leaves, in the
    order of ``leaves(template)``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def path_key(path: Path) -> str:
    """A leaf's path as one string, the parts joined by ``/``."""
    return SEP.join(str(p) for p in path)


Layout = Tuple[List[int], List[List[int]]]


def stack_layers(params, layout: Optional[Layout]):
    """``params`` with its ``layers`` list replaced by the reference's
    ``steps/layers``: a list with, for each position ``j`` of a step of
    ``layout``, one layer dict whose leaves are those of the steps'
    ``j``-th layers stacked on a new leading axis (a last step cut short
    of a period stacks into the positions it has).  The prefix layers
    stay unstacked under ``prefix``, as the reference's unrolled prefix
    does.  A tree without a ``layers`` list comes back as it is."""
    layers = params.get("layers")
    if not isinstance(layers, list):
        return params
    if layout is None:
        raise ValueError("stacking a layer list needs the model's layout "
                         "(models.blocks.step_layout)")
    prefix, steps = layout
    out = dict(params)
    if prefix:
        out["prefix"] = [layers[i] for i in prefix]
    out["layers"] = [
        tree_map(lambda *xs: torch.stack(xs),
                 *(layers[step[j]] for step in steps if j < len(step)))
        for j in range(max(map(len, steps), default=0))]
    return out


def unstack_layers(stacked, layout: Optional[Layout]):
    """Inverse of ``stack_layers(..., layout)``: one layer dict per layer,
    the prefix layers as they are and views of the stacked leaves."""
    if "layers" not in stacked:
        return stacked
    prefix, steps = layout
    out = {k: v for k, v in stacked.items() if k != "prefix"}
    layers = [None] * (len(prefix) + sum(len(step) for step in steps))
    for i, layer in zip(prefix, stacked.get("prefix", [])):
        layers[i] = layer
    for s, step in enumerate(steps):
        for j, i in enumerate(step):
            layers[i] = tree_map(lambda x, s=s: x[s], stacked["layers"][j])
    out["layers"] = layers
    return out
