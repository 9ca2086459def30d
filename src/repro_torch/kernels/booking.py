"""The kernels' work, booked with the active op counts.

A hand-written kernel is a ``ctypes`` launch that no dispatch mode sees,
and on fake tensors (a dry run) it does no arithmetic at all, so an op
count of a step (``roofline.flop_count.OpCounter``) cannot read the
kernels' FLOPs and bytes off their operators.  Each wrapper books its
call instead, by name, from its kernel's ``*_work`` formula (the same
arithmetic ``chip_smoke.py`` phase 4 bounds the kernel with):

* on a fake tensor the wrapper books and returns outputs of the kernel's
  own shapes and types, with no arithmetic;
* on a CUDA tensor it books beside the launch;
* on a CPU tensor it books and runs its plain version ``unseen``: the
  plain version's own operators are not also counted.

A count is anything with ``book_kernel(name, flops, nbytes)`` and a
``paused`` depth, active while it is in ``ACTIVE`` (an
``OpCounter`` adds itself there while it is entered); with none active,
``book`` does nothing and the wrappers compute no work.

``repeated(n)``: every count made in its block (the op count's
operators and booked kernels, ``roofline.analysis.count_collectives``'s
collectives) stands for ``n`` identical ones, as the reference's HLO
walker multiplies a ``while`` body by its trip count: a dry run traces
one microbatch of a gradient-accumulation loop whose microbatches issue
the same operators on the same shapes.  Importing this module touches no
device.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

ACTIVE: List = []
# the factor of the innermost ``repeated`` block (1 outside any)
_REPEAT: List[int] = [1]


def active() -> bool:
    """Whether a count is active (a wrapper computes its work only
    then)."""
    return bool(ACTIVE)


def book(name: str, flops: float, nbytes: float) -> None:
    """Book one call of kernel ``name`` with every active count."""
    for count in ACTIVE:
        count.book_kernel(name, float(flops), float(nbytes))


def repeat() -> int:
    """How many identical counts one count made now stands for."""
    return _REPEAT[-1]


@contextlib.contextmanager
def repeated(n: int):
    """Every count made in the block stands for ``n`` (nested blocks
    multiply)."""
    _REPEAT.append(_REPEAT[-1] * n)
    try:
        yield
    finally:
        _REPEAT.pop()


@contextlib.contextmanager
def unseen():
    """The block's operators (a plain version standing in for a booked
    kernel) are not counted by the active counts."""
    for count in ACTIVE:
        count.paused += 1
    try:
        yield
    finally:
        for count in ACTIVE:
            count.paused -= 1


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes and types, no data)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


def live_count(lengths: torch.Tensor, capacity: int) -> int:
    """The live entries a decode call attends: the sum of ``lengths``
    (each clamped to ``capacity``); on a fake tensor, whose values are
    unknown, every slot full (``capacity`` a slot), which is what a step
    at the cache's last position reads.  Reading a CUDA tensor's values
    syncs the host with the card: only a counted step pays it."""
    if is_fake(lengths):
        return int(lengths.shape[0]) * capacity
    with unseen():
        return int(lengths.clamp(0, capacity).sum())
