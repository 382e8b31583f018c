from icpx_torch.io.loaders import load_cloud, save_cloud
from icpx_torch.io.pcd import read_pcd, write_pcd

__all__ = ["read_pcd", "write_pcd", "load_cloud", "save_cloud"]
