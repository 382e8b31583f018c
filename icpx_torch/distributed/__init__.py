from icpx_torch.distributed.fault import (
    CollectiveStallError,
    HeartbeatMonitor,
    default_stall_timeout,
    degenerate_solve_guard,
    guarded_call,
)

__all__ = [
    "CollectiveStallError",
    "HeartbeatMonitor",
    "default_stall_timeout",
    "degenerate_solve_guard",
    "guarded_call",
]
