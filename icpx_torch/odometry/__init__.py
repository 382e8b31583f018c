from icpx_torch.odometry.compiled import (
    CompiledOdometry,
    OdometryFrame,
    OdometryStream,
    run_odometry_compiled,
)
from icpx_torch.odometry.evaluate import ate_rmse, kitti_relative_error, rpe
from icpx_torch.odometry.frontend import (
    MotionState,
    OdometryConfig,
    OdometryResult,
    blend_velocity,
    run_odometry,
)
from icpx_torch.odometry.parallel import batched_pair_seed, parallel_odometry
from icpx_torch.odometry.posegraph import (
    PoseGraph,
    SlidingWindowBackend,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
    optimize_pose_graph_sparse,
)

__all__ = [
    "CompiledOdometry",
    "MotionState",
    "OdometryConfig",
    "OdometryFrame",
    "OdometryResult",
    "OdometryStream",
    "PoseGraph",
    "SlidingWindowBackend",
    "ate_rmse",
    "batched_pair_seed",
    "kitti_relative_error",
    "blend_velocity",
    "optimize_pose_graph",
    "optimize_pose_graph_sharded",
    "optimize_pose_graph_sparse",
    "parallel_odometry",
    "rpe",
    "run_odometry",
    "run_odometry_compiled",
]
