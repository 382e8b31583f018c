from icpx_torch.geometry.se3 import SE3
from icpx_torch.geometry.transforms import (
    apply_transform,
    make_rigid_perturbation,
    rotate_vectors,
    transform_cloud,
)

__all__ = [
    "SE3",
    "apply_transform",
    "rotate_vectors",
    "transform_cloud",
    "make_rigid_perturbation",
]
