"""icpx_torch — the PyTorch / CUDA port of `icpx` for one NVIDIA H100.

The package mirrors `icpx/` module for module: each counterpart sits at the
same relative path and keeps the same public names. It imports `torch` and
numpy only; `icpx` (JAX) is the reference it is tested against, never a
runtime dependency.

Ported so far: the registration layer. Single-pair registration
(`registration.icp.register`, `register_xyz`), symmetric, point-to-plane,
point-to-point and GICP, on the brute-force NN path (targets below
`ICPConfig.block_auto_threshold`, or `nn_method="brute"`) and on the
block-NN path (KD tile indexes, in-registration normals or GICP
covariances, coarse, refine-stride mid and frozen-candidate refine phases,
the feature-augmented metric: the 1M flagship); batched pairs
(`register_batch` on the brute path, `register_batch_block` on the block
path); Horn/Umeyama (`registration.horn`); the coarse-to-fine pyramid
(`registration.pyramid`); NDT (`registration.ndt`); the voxel-hash NN
(`kernels.voxel`) and the tile-index k-NN (`kernels.blocknn.block_knn`);
payload features on `PointCloud`. Odometry (`odometry/`): the LiDAR
simulator and KITTI ingest, ATE / RPE / the KITTI relative error, the
whole-sequence path (`run_odometry_compiled`), the host frontend
(`run_odometry`: scan-to-keyframe and scan-to-map over a voxel map, the
motion gate, dynamic masking, the sliding-window back end, exact resume
from `utils.checkpoint.OdometryCheckpoint`), the dense and sparse pose-graph
solvers with Schur marginalization, place recognition and loop closure,
the stall watchdog and the fault injectors (`distributed.fault`). IO and
the command line: PCD (ascii, binary, LZF binary_compressed), PLY, xyz text
and KITTI .bin through the native reader (`io/native.py`, a ctypes binding
of `native/icpx_io.cpp`), payload feature columns, scan prefetching,
metrics, generic checkpoints, profiling, debug helpers, snapshots
(`viz`) and `cli` (``python -m icpx_torch.cli``). Its hand-written CUDA kernels, one for
each Pallas kernel of the reference: the exact 1-NN search
(`kernels/nn_cuda.py` + `csrc/nn.cu`), the block path's radius moments,
folds, payload selection, union fold and union moments
(`kernels/blocknn_cuda.py` + `csrc/blocknn.cu`), and the KD build's
segmented sort (`kernels/sort_cuda.py` + `csrc/sort.cu`). Entry points
create tensors on the first CUDA device unless given `device="cpu"`. The
sharded pose graph, `parallel_odometry`, the rest of `distributed/` and
the HLO tooling wait for ROADMAP queue 1 step 9.
"""

import torch as _torch

# Registration contracts tiny dimensions (K=3 distance cross terms, K<=8
# normal-equation and covariance products) over global coordinates; TF32
# keeps ~3 decimal digits, which corrupts squared distances and 6x6 solves
# at coordinate magnitudes ~1e2. Full fp32 costs nearly nothing at these K.
# Mirrors `jax_default_matmul_precision="highest"` in icpx/__init__.py.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from icpx_torch.cloud import PointCloud  # noqa: E402
from icpx_torch.geometry.se3 import SE3  # noqa: E402
from icpx_torch.io.loaders import load_cloud, save_cloud  # noqa: E402
from icpx_torch.registration.horn import horn_align  # noqa: E402
from icpx_torch.registration.icp import ICPConfig, ICPResult, register  # noqa: E402
from icpx_torch.registration.pyramid import PyramidConfig, register_pyramid  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PointCloud",
    "SE3",
    "ICPConfig",
    "ICPResult",
    "register",
    "horn_align",
    "PyramidConfig",
    "register_pyramid",
    "load_cloud",
    "save_cloud",
    "__version__",
]
