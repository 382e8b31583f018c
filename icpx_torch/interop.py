"""State carried across from the JAX package, as numpy arrays and dicts.

The JAX package's objects convert to numpy (`np.asarray(cloud.xyz)`,
`dataclasses.asdict(config)`, ...) and these functions turn that into the
port's objects (clouds, transforms, tile indexes, configs, pose graphs,
voxel maps, map blocks), and results back into numpy (ICP results, voxel
maps, whole-sequence odometry, map blocks), so both packages
can compute on identical bits and carry state across. Nothing here imports
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud
from icpx_torch.distributed.map_ep import MapBlocks
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.blocknn import TileIndex
from icpx_torch.odometry.compiled import CompiledOdometry
from icpx_torch.odometry.mapping import VoxelMap
from icpx_torch.odometry.posegraph import PoseGraph
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


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pose_graph_from_numpy(graph, *, device=DEFAULT_DEVICE) -> PoseGraph:
    """A port PoseGraph from any object with the JAX `PoseGraph` fields
    (`poses` and `edge_meas` with R and t, `edge_i`, `edge_j`,
    `edge_weight`), taken as they are."""
    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return PoseGraph(
        poses=se3_from_numpy(graph.poses.R, graph.poses.t, device=device),
        edge_i=i32(graph.edge_i),
        edge_j=i32(graph.edge_j),
        edge_meas=se3_from_numpy(graph.edge_meas.R, graph.edge_meas.t, device=device),
        edge_weight=torch.tensor(np.asarray(graph.edge_weight, np.float32), device=device),
    )


_MAP_FIELDS = ("block_xyz", "block_normals", "block_mask", "boundaries", "lo", "inv_extent")


def map_blocks_from_numpy(blocks, *, device=DEFAULT_DEVICE) -> MapBlocks:
    """The port's MapBlocks from any object with the JAX `MapBlocks`
    fields, taken as they are (the same partition in both packages)."""
    return MapBlocks(**{f: torch.tensor(np.asarray(getattr(blocks, f)), device=device)
                        for f in _MAP_FIELDS})


def map_blocks_to_numpy(blocks: MapBlocks) -> Dict[str, np.ndarray]:
    return {f: _host(getattr(blocks, f)) for f in _MAP_FIELDS}


def voxel_map_from_numpy(vmap, *, device=DEFAULT_DEVICE) -> VoxelMap:
    """A port VoxelMap from any object with the JAX `VoxelMap` fields,
    taken as they are (a map the JAX package built continues in the port)."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return VoxelMap(
        xyz=f32(vmap.xyz),
        normals=f32(vmap.normals),
        mask=torch.tensor(np.asarray(vmap.mask, bool), device=device),
        age=torch.tensor(np.asarray(vmap.age, np.int32), device=device),
        cell_size=f32(vmap.cell_size),
        counter=torch.tensor(np.asarray(vmap.counter, np.int32), device=device),
        feats=None if vmap.feats is None else f32(vmap.feats),
        feat_names=tuple(vmap.feat_names) if vmap.feat_names else None,
    )


def voxel_map_to_numpy(vmap: VoxelMap) -> Dict[str, Any]:
    """Every field of a port VoxelMap as host numpy (feats None where it has
    none), and feat_names."""
    out = {f: None if getattr(vmap, f) is None else _host(getattr(vmap, f))
           for f in ("xyz", "normals", "mask", "age", "cell_size", "counter", "feats")}
    out["feat_names"] = vmap.feat_names
    return out


def compiled_odometry_to_numpy(res: CompiledOdometry) -> Dict[str, np.ndarray]:
    """Every field of a `CompiledOdometry` as host numpy, SE3 fields split
    into `<name>_R` and `<name>_t` (as the JAX object converts with
    `np.asarray` field by field)."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if v is None:
            continue
        if isinstance(v, SE3):
            out[f"{f.name}_R"], out[f"{f.name}_t"] = _host(v.R), _host(v.t)
        else:
            out[f.name] = _host(v)
    return out
