from icpx_torch.kernels.eigh3 import eigh3x3, smallest_eigenvector_3x3
from icpx_torch.kernels.knn import knn, nearest_neighbor, pairwise_sqdist
from icpx_torch.kernels.normals import estimate_covariances, estimate_normals

__all__ = [
    "knn",
    "nearest_neighbor",
    "pairwise_sqdist",
    "estimate_normals",
    "estimate_covariances",
    "eigh3x3",
    "smallest_eigenvector_3x3",
]
