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
    nrm = None if jc.normals is None else np.asarray(jc.normals)
    cov = None if jc.covs is None else np.asarray(jc.covs)
    return interop.cloud_from_numpy(
        np.asarray(jc.xyz), np.asarray(jc.mask), nrm, cov, device=device
    )


def torch_se3(js, device="cpu"):
    return interop.se3_from_numpy(np.asarray(js.R), np.asarray(js.t), device=device)


def torch_config(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))
