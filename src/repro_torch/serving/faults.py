"""Swap verification for the paged serving engine.

Torch counterpart of the part of ``repro.serving.faults`` that preemption
by swap needs: ``SwapFailed`` and ``checksum``.  A swapped-out slot's
host buffers carry a crc32 taken when they were written; swap-in checks
it again before restoring, so a corrupted buffer degrades to recompute
(or fails the request, per ``ServeConfig.swap_fallback``) instead of
resuming from garbage.
"""
from __future__ import annotations

import zlib

import torch


class SwapFailed(RuntimeError):
    """A host-RAM swap could not complete (or failed verification)."""


def _leaves(tree):
    """Leaves in a fixed order: lists and tuples in order, dicts by sorted
    key (the order ``jax.tree.leaves`` gives the reference's buffers)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def checksum(bufs) -> int:
    """crc32 over nested lists / dicts of host buffers (CPU tensors or
    numpy arrays), their bytes in a fixed leaf order."""
    crc = 0
    for leaf in _leaves(bufs):
        t = torch.as_tensor(leaf).contiguous().reshape(-1)
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
    return crc
