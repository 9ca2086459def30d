"""Where the port's entry points run.

The port is written for one CUDA device.  A caller that wants the CPU
(the tests, the CPU twin of a chip check) says so by passing a CPU
device; with no device given and no GPU present, an entry point raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda``
    (a CUDA device always with its index, so devices compare equal).

    Raises ``RuntimeError`` when no device is given and CUDA is not
    available."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch "
            "versions on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a CUDA device the copy
    is made from pinned memory with ``non_blocking=True``: a copy from
    pageable memory waits for the stream to drain, stalling the host
    (PyTorch's pinned allocator keeps the staging buffer alive until the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


def tree_to(tree, device: DeviceLike):
    """A copy of nested dicts / lists of tensors (params, caches,
    projections) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
