"""State carried across from the JAX package, as numpy arrays and dicts.

The JAX package's objects convert to numpy (`np.asarray(cloud.xyz)`,
`dataclasses.asdict(config)`, ...) and these functions turn that into the
port's objects, and a result back into numpy, so both packages can
compute on identical bits. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import TileIndex
from icpx_torch.registration.icp import ICPConfig, ICPResult

_INDEX_FIELDS = ("tiles", "box_lo", "box_hi", "centroids", "order")


def cloud_from_numpy(xyz, mask, normals=None, covs=None, *, device=DEFAULT_DEVICE) -> PointCloud:
    """A cloud from padded arrays (normals (N, 3) and GICP covariances
    (N, 3, 3) optional), taken as they are (no re-padding)."""
    xyz = torch.tensor(np.asarray(xyz, dtype=np.float32), device=device)
    mask = torch.tensor(np.asarray(mask, dtype=bool), device=device)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or tuple(mask.shape) != (xyz.shape[0],):
        raise ValueError(f"need xyz (N, 3) and mask (N,), got {tuple(xyz.shape)}, "
                         f"{tuple(mask.shape)}")
    nrm = cov = None
    if normals is not None:
        nrm = torch.tensor(np.asarray(normals, dtype=np.float32), device=device)
        if nrm.shape != xyz.shape:
            raise ValueError(f"normals must be {tuple(xyz.shape)}, got {tuple(nrm.shape)}")
    if covs is not None:
        cov = torch.tensor(np.asarray(covs, dtype=np.float32), device=device)
        if tuple(cov.shape) != (xyz.shape[0], 3, 3):
            raise ValueError(f"covs must be ({xyz.shape[0]}, 3, 3), got {tuple(cov.shape)}")
    return PointCloud(xyz=xyz, mask=mask, normals=nrm, covs=cov)


def cloud_to_numpy(cloud: PointCloud) -> Dict[str, np.ndarray]:
    """Every field of a port cloud as host numpy (None where it has none):
    xyz, mask, normals, covs, padded as they are."""
    return {f: None if getattr(cloud, f) is None else getattr(cloud, f).detach().cpu().numpy()
            for f in ("xyz", "mask", "normals", "covs")}


def se3_from_numpy(R, t, *, device=DEFAULT_DEVICE) -> SE3:
    return SE3(
        R=torch.tensor(np.asarray(R, dtype=np.float32), device=device),
        t=torch.tensor(np.asarray(t, dtype=np.float32), device=device),
    )


def tile_index_from_numpy(index, *, device=DEFAULT_DEVICE) -> TileIndex:
    """A port TileIndex from any object with the JAX `TileIndex` fields
    (`tiles`, `box_lo`, `box_hi`, `centroids`, `order`), taken as they are."""
    arrays = {f: np.asarray(getattr(index, f)) for f in _INDEX_FIELDS}
    out = {f: torch.tensor(a.astype(np.float32 if f != "order" else np.int32), device=device)
           for f, a in arrays.items()}
    return TileIndex(**out)


def tile_index_to_numpy(index: TileIndex) -> Dict[str, np.ndarray]:
    """Every field of a port TileIndex as host numpy."""
    return {f: getattr(index, f).detach().cpu().numpy() for f in _INDEX_FIELDS}


def config_from_dict(d: Dict[str, Any]) -> ICPConfig:
    """An ICPConfig from `dataclasses.asdict` of the JAX package's config;
    unknown keys raise, so the two field sets cannot drift apart silently."""
    names = {f.name for f in dataclasses.fields(ICPConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown ICPConfig fields: {sorted(extra)}")
    return ICPConfig(**d)


def result_to_numpy(res: ICPResult) -> Dict[str, np.ndarray]:
    """Every field of a result as host numpy (R and t for the transform)."""
    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    return {
        "R": host(res.transform.R),
        "t": host(res.transform.t),
        "iters": np.asarray(res.iters),
        "converged": host(res.converged),
        "diff_history": host(res.diff_history),
        "rmse_history": host(res.rmse_history),
        "final_rmse": host(res.final_rmse),
        "inlier_count": host(res.inlier_count),
    }
