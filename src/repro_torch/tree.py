"""Nested dicts and lists of tensors: the port's pytrees.

The port's parameters, optimizer states and checkpoints are plain nested
dicts and lists (``models.model`` documents the parameter layout).  These
helpers walk them by path, the way the reference walks its JAX pytrees:

    leaves(tree)              -> [(path, leaf), ...] in a fixed order
    unflatten(template, vals) -> template's structure, vals as its leaves
    tree_map(fn, tree, *rest) -> the same structure, fn on each leaf
    path_key(path)            -> "layers/0/attn/wq" (checkpoint keys)
    stack_layers(params)      -> "layers" as one dict of (L, ...) leaves
                                 (a heterogeneous "prefix" apart)
    unstack_layers(st, like)  -> back to a list of per-layer dicts

``stack_layers`` gives the reference's own layout of a stack (its
``steps/layers/0`` leaves carry a leading layer axis, its unrolled
``prefix`` layers do not), which is what Adafactor's statistics and
update clip are taken over.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

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


def prefix_len(layers: Sequence) -> int:
    """How many leading layers differ in structure (leaf paths and
    shapes) from the last one: the reference's unrolled prefix, such as
    DeepSeek-V2's dense first layer before its MoE layers; 0 for a
    homogeneous stack."""
    def signature(layer):
        return [(path, tuple(x.shape)) for path, x in leaves(layer)]
    last = signature(layers[-1])
    n = 0
    while n < len(layers) and signature(layers[n]) != last:
        n += 1
    return n


def stack_layers(params):
    """``params`` with its ``layers`` list replaced by one layer dict whose
    leaves are the per-layer leaves stacked on a new leading axis, the
    reference's ``steps/layers/0``; leading layers of another structure
    (``prefix_len``) stay unstacked under ``prefix``, as the reference's
    unrolled prefix does.  A tree without a ``layers`` list comes back as
    it is."""
    layers = params.get("layers")
    if not isinstance(layers, list):
        return params
    n = prefix_len(layers)
    out = dict(params)
    if n:
        out["prefix"] = list(layers[:n])
    out["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers[n:])
    return out


def unstack_layers(stacked, like):
    """Inverse of ``stack_layers(like)``: the prefix layers, then views of
    the stacked leaves, one layer dict per layer of ``like``."""
    if not isinstance(like.get("layers"), list):
        return stacked
    out = {k: v for k, v in stacked.items() if k != "prefix"}
    prefix = list(stacked.get("prefix", []))
    out["layers"] = prefix + [
        tree_map(lambda x, i=i: x[i], stacked["layers"])
        for i in range(len(like["layers"]) - len(prefix))]
    return out
