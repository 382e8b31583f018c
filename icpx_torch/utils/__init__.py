from icpx_torch.utils.metrics import MetricsLogger, icp_iteration_records
from icpx_torch.utils.profiling import Timer, time_fn, trace_context
from icpx_torch.utils.checkpoint import OdometryCheckpoint, load_checkpoint, save_checkpoint
from icpx_torch.utils.debug import (
    assert_all_finite,
    deterministic_mode,
    nan_checks,
    shard_equivalence_report,
)

__all__ = [
    "MetricsLogger",
    "icp_iteration_records",
    "Timer",
    "time_fn",
    "trace_context",
    "save_checkpoint",
    "load_checkpoint",
    "OdometryCheckpoint",
    "assert_all_finite",
    "deterministic_mode",
    "nan_checks",
    "shard_equivalence_report",
]
