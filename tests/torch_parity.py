"""Shared helpers for the parity tests of the PyTorch port (`icpx_torch`)
against the JAX package (`icpx`). Not collected (no `test_` prefix).

Inputs are made once with numpy, then handed to both packages as the same
bits: JAX objects go to numpy and through `icpx_torch.interop`.
"""

import dataclasses

import numpy as np
import torch

from icpx.cloud import PointCloud as JCloud
from icpx_torch import interop

# The suite runs under pytest-xdist with several workers: keep each
# worker's intra-op pool small so they do not oversubscribe the host.
torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clouds(xyz, normals=None, capacity=None):
    """(JAX PointCloud, port PointCloud) from one (n, 3) numpy array,
    padded once by the JAX package and carried across as numpy."""
    jc = JCloud.create(xyz, normals=normals, capacity=capacity)
    tc = torch_cloud(jc)
    return jc, tc


def torch_cloud(jc, device="cpu"):
    def host(x):
        return None if x is None else np.asarray(x)

    return interop.cloud_from_numpy(
        np.asarray(jc.xyz), np.asarray(jc.mask), host(jc.normals), host(jc.covs),
        host(jc.feats), jc.feat_names, device=device
    )


def torch_se3(js, device="cpu"):
    return interop.se3_from_numpy(np.asarray(js.R), np.asarray(js.t), device=device)


def torch_config(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def torch_pyramid_config(jcfg):
    return interop.pyramid_config_from_dict(dataclasses.asdict(jcfg))


def rotation(rng, max_angle=3.0) -> np.ndarray:
    """A float32 rotation matrix of a random axis and an angle up to
    `max_angle`, from numpy (Rodrigues)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def torch_odometry_config(jcfg):
    """The port's OdometryConfig from the JAX package's, field for field."""
    from icpx_torch.odometry.frontend import OdometryConfig

    d = dataclasses.asdict(jcfg)
    d["icp"] = interop.config_from_dict(d["icp"])
    return OdometryConfig(**d)
