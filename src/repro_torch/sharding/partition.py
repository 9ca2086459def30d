"""Devices and slot slices of the data-axis sharded serving engine.

Torch counterpart of the serving half of ``repro.sharding.partition``.
The reference lays the engine's slot axis, page pools and sampling keys
over a 1-D ``("data",)`` mesh (``serve_mesh``) and cuts dim 0 of each
array into one contiguous slice a device (``slot_spec``,
``slot_sharding``).  A torch tensor lives on one device, so the port's
shards own their tensors outright: ``serve_devices`` is the list of
devices the shards run on, and ``slot_slice`` / ``slot_slices`` say which
slice of the global slot axis each shard serves.

The training half waits for the port's multi-device training slice
(``ROADMAP.md`` queue 1): the active-mesh context (``use_mesh``,
``active_mesh``), the axis queries (``dp_axes``, ``axis_size``,
``maybe_axis``), the activation constraint ``shard``, ``named`` and the
parameter rules ``param_spec`` and ``params_shardings``.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import DeviceLike, resolve_device


def serve_devices(shards: int, device: DeviceLike = None
                  ) -> List[torch.device]:
    """The devices of a ``shards``-way sharded engine, one a shard: the
    first ``shards`` CUDA devices, or, given ``device``, that device
    ``shards`` times (the CPU tests; one card serving every shard).

    Raises ``ValueError`` when fewer CUDA devices exist than shards."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if device is not None:
        return [resolve_device(device)] * shards
    n = torch.cuda.device_count()
    if n < shards:
        raise ValueError(
            f"serve_devices needs {shards} devices, found {n} CUDA "
            f"device(s) (pass device=... to place every shard on one "
            f"device)")
    return [torch.device("cuda", i) for i in range(shards)]


def slot_slice(shard: int, per_shard: int) -> slice:
    """Shard ``shard``'s contiguous slice of the global slot axis, each
    shard owning ``per_shard`` slots."""
    return slice(shard * per_shard, (shard + 1) * per_shard)


def slot_slices(n_slots: int, shards: int) -> List[slice]:
    """The global slot axis of ``n_slots`` cut into ``shards`` equal
    contiguous slices, in shard order; raises ``ValueError`` when the
    shards do not divide it."""
    if shards < 1 or n_slots % shards:
        raise ValueError(
            f"{n_slots} slots do not split into {shards} equal shards")
    return [slot_slice(s, n_slots // shards) for s in range(shards)]
