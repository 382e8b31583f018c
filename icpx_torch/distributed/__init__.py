from icpx_torch.distributed.fault import (
    CollectiveStallError,
    HeartbeatMonitor,
    corrupt_points,
    default_stall_timeout,
    degenerate_solve_guard,
    drop_shard,
    guarded_call,
)

__all__ = [
    "CollectiveStallError",
    "HeartbeatMonitor",
    "corrupt_points",
    "default_stall_timeout",
    "degenerate_solve_guard",
    "drop_shard",
    "guarded_call",
]
