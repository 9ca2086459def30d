"""Placement helpers of the sharded serving engine
(``repro_torch.sharding.partition``)."""
from repro_torch.sharding.partition import (serve_devices, slot_slice,
                                            slot_slices)

__all__ = ["serve_devices", "slot_slice", "slot_slices"]
