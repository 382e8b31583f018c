"""icpx_torch — the PyTorch / CUDA port of `icpx` for one NVIDIA H100.

The package mirrors `icpx/` module for module: each counterpart sits at the
same relative path and keeps the same public names. It imports `torch` and
numpy only; `icpx` (JAX) is the reference it is tested against, never a
runtime dependency.

This first slice covers single-pair registration on the brute-force NN
path (`registration.icp.register` for targets below
`ICPConfig.block_auto_threshold`, or any size with `nn_method="brute"`).
Its one hand-written kernel is the exact 1-NN search in
`kernels/nn_cuda.py` + `csrc/nn.cu`, which replaces the Pallas
`knn_pallas._nn_kernel`. Paths that need later slices (block NN, GICP,
compressed PCD, ...) raise `NotImplementedError` naming their ROADMAP step.
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
from icpx_torch.registration.icp import ICPConfig, ICPResult, register  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "PointCloud",
    "SE3",
    "ICPConfig",
    "ICPResult",
    "register",
    "load_cloud",
    "save_cloud",
    "__version__",
]
