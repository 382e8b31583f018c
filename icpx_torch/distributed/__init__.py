"""The distributed layer on `torch.distributed`: meshes, collectives,
sharded and ring ICP, map blocks with all-to-all routing, the stage
pipeline, multi-host bring-up, and the stall watchdog and fault injectors.

Mirrors `icpx/distributed/`. The names load on first use: the sharded
paths import the registration layer, which itself imports
`distributed.fault`.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "mesh_shape_for": "mesh",
    "ring_nearest_neighbor": "ring",
    "sharded_register": "sharded_icp",
    "sharded_register_pairs": "sharded_icp",
    "MapBlocks": "map_ep",
    "partition_map": "map_ep",
    "routed_map_nn": "map_ep",
    "sharded_map_register": "map_ep",
    "pipelined_pyramid_register": "pipeline",
    "CollectiveStallError": "fault",
    "HeartbeatMonitor": "fault",
    "corrupt_points": "fault",
    "default_stall_timeout": "fault",
    "degenerate_solve_guard": "fault",
    "drop_shard": "fault",
    "guarded_call": "fault",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
