"""Placement rules (``repro_torch.sharding.partition``): the parameter
partition rules, the active mesh and the activation constraint of
training on a device mesh, and the sharded serving engine's devices and
slot slices."""
from repro_torch.sharding.partition import (NamedSharding, active_mesh,
                                            axis_size, dp_axes, maybe_axis,
                                            named, param_spec,
                                            params_shardings, serve_devices,
                                            shard, slot_slice, slot_slices,
                                            use_mesh)

__all__ = ["NamedSharding", "active_mesh", "axis_size", "dp_axes",
           "maybe_axis", "named", "param_spec", "params_shardings",
           "serve_devices", "shard", "slot_slice", "slot_slices", "use_mesh"]
