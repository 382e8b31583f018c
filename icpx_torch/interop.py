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
from icpx_torch.registration.pyramid import PyramidConfig

_INDEX_FIELDS = ("tiles", "box_lo", "box_hi", "centroids", "order")


def cloud_from_numpy(xyz, mask, normals=None, covs=None, feats=None, feat_names=None, *,
                     device=DEFAULT_DEVICE) -> PointCloud:
    """A cloud from padded arrays (normals (N, 3), GICP covariances
    (N, 3, 3) and payload features (N, F) with their names optional), taken
    as they are (no re-padding)."""
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
    ft = None
    if feats is not None:
        ft = torch.tensor(np.asarray(feats, dtype=np.float32), device=device)
        if ft.ndim != 2 or ft.shape[0] != xyz.shape[0]:
            raise ValueError(f"feats must be ({xyz.shape[0]}, F), got {tuple(ft.shape)}")
        if feat_names is not None and len(feat_names) != ft.shape[1]:
            raise ValueError(f"{len(feat_names)} feat_names for {ft.shape[1]} feature columns")
    return PointCloud(xyz=xyz, mask=mask, normals=nrm, covs=cov, feats=ft,
                      feat_names=tuple(feat_names) if feat_names else None)


def cloud_to_numpy(cloud: PointCloud) -> Dict[str, Any]:
    """Every field of a port cloud as host numpy (None where it has none):
    xyz, mask, normals, covs, feats, padded as they are, and feat_names."""
    out = {f: None if getattr(cloud, f) is None else getattr(cloud, f).detach().cpu().numpy()
           for f in ("xyz", "mask", "normals", "covs", "feats")}
    out["feat_names"] = cloud.feat_names
    return out


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


def pyramid_config_from_dict(d: Dict[str, Any]) -> PyramidConfig:
    """A PyramidConfig from `dataclasses.asdict` of the JAX package's (its
    `base` an ICPConfig dict, `iters_per_level` a tuple); unknown keys
    raise, as in `config_from_dict`."""
    names = {f.name for f in dataclasses.fields(PyramidConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown PyramidConfig fields: {sorted(extra)}")
    d = dict(d)
    if "base" in d:
        d["base"] = config_from_dict(d["base"])
    if "iters_per_level" in d:
        d["iters_per_level"] = tuple(d["iters_per_level"])
    return PyramidConfig(**d)


def result_to_numpy(res: ICPResult) -> Dict[str, np.ndarray]:
    """Every field of a result as host numpy (R and t for the transform); a
    batched result's fields keep their leading (B,) dimension."""
    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    return {
        "R": host(res.transform.R),
        "t": host(res.transform.t),
        "iters": host(res.iters),
        "converged": host(res.converged),
        "diff_history": host(res.diff_history),
        "rmse_history": host(res.rmse_history),
        "final_rmse": host(res.final_rmse),
        "inlier_count": host(res.inlier_count),
    }
