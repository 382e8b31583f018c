from icpx_torch.io.pcd import read_pcd, write_pcd
from icpx_torch.io.ply import read_ply, write_ply
from icpx_torch.io.xyz import read_xyz_txt, write_xyz_txt
from icpx_torch.io.loaders import load_cloud, save_cloud
from icpx_torch.io.prefetch import ScanPrefetcher, prefetch_kitti

__all__ = [
    "read_pcd",
    "write_pcd",
    "read_ply",
    "write_ply",
    "read_xyz_txt",
    "write_xyz_txt",
    "load_cloud",
    "save_cloud",
    "ScanPrefetcher",
    "prefetch_kitti",
]
