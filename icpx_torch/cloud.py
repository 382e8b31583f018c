"""Point-cloud container: a fixed-capacity, mask-padded dataclass of tensors.

Mirrors `icpx/cloud.py`. A cloud is an ``(N, 3)`` float32 tensor plus an
``(N,)`` validity mask; capacity is padded to a multiple of PAD_MULTIPLE
with PAD_COORD sentinel rows, so shapes (and therefore the tensors the
port hands to its kernels) are identical to the JAX package's. Every
consumer respects the mask. GICP covariances ride along as (N, 3, 3), the
identity on pad rows, and payload features (intensity, reflectance, ...)
as (N, F) columns named by `feat_names`, zero on pad rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# Same padding contract as the JAX package, so padded shapes and sentinel
# rows agree bit for bit between the two.
PAD_MULTIPLE = 128

# Coordinate used for padded (invalid) rows: large but finite, so squared
# distances stay finite in fp32 (1e8**2 = 1e16 << 3.4e38).
PAD_COORD = 1.0e8

# Where the entry points put new tensors unless the caller names a device:
# the port runs on the card, and the CPU is asked for with device="cpu".
DEFAULT_DEVICE = torch.device("cuda", 0)


def round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class PointCloud:
    """A padded point cloud.

    Attributes:
      xyz:     (N, 3) float32; rows with ``mask == False`` hold PAD_COORD.
      mask:    (N,) bool — True for real points.
      normals: optional (N, 3) float32 unit normals (zero rows where unknown).
      covs:    optional (N, 3, 3) float32 regularised neighbourhood
               covariances (GICP); pad rows hold the identity.
      feats:   optional (N, F) float32 payload channels (intensity,
               reflectance, labels, ...); pad rows hold 0. They ride along
               rigid transforms unchanged; `feat_names` names the columns.
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    covs: Optional[torch.Tensor] = None
    feats: Optional[torch.Tensor] = None
    feat_names: Optional[Tuple[str, ...]] = None

    # ---- construction ------------------------------------------------------

    @classmethod
    def create(
        cls,
        xyz,
        normals=None,
        *,
        capacity: Optional[int] = None,
        pad_multiple: int = PAD_MULTIPLE,
        device=None,
        covs=None,
        feats=None,
        feat_names: Optional[tuple] = None,
    ) -> "PointCloud":
        """Build a padded cloud from an (n, 3) array (numpy or tensor), with
        optional (n, 3) normals, (n, 3, 3) covariances and (n, F) or (n,)
        payload features named by `feat_names` (one name a column).

        It lands on `device`; when that is None, on the tensor's own device
        for a tensor, and on the first CUDA device otherwise (pass
        ``device="cpu"`` for the CPU)."""
        if device is None and torch.is_tensor(xyz):
            device = xyz.device
        device = DEFAULT_DEVICE if device is None else torch.device(device)
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
        if xyz.ndim != 2 or xyz.shape[1] != 3:
            raise ValueError(f"xyz must be (n, 3), got {tuple(xyz.shape)}")
        n = xyz.shape[0]
        cap = capacity if capacity is not None else round_up(max(n, 1), pad_multiple)
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")
        pad = cap - n
        xyz_p = torch.cat(
            [xyz, torch.full((pad, 3), PAD_COORD, dtype=torch.float32, device=device)]
        )
        mask = torch.arange(cap, device=device) < n
        nrm_p = None
        if normals is not None:
            normals = torch.as_tensor(normals, dtype=torch.float32, device=device)
            if tuple(normals.shape) != (n, 3):
                raise ValueError(
                    f"normals must be (n, 3)={n}, got {tuple(normals.shape)}"
                )
            nrm_p = torch.cat(
                [normals, torch.zeros((pad, 3), dtype=torch.float32, device=device)]
            )
        cov_p = None
        if covs is not None:
            covs = torch.as_tensor(covs, dtype=torch.float32, device=device)
            if tuple(covs.shape) != (n, 3, 3):
                raise ValueError(f"covs must be (n, 3, 3)={n}, got {tuple(covs.shape)}")
            eye = torch.eye(3, dtype=torch.float32, device=device).expand(pad, 3, 3)
            cov_p = torch.cat([covs, eye])
        feats_p = None
        if feats is not None:
            feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
            if feats.ndim == 1:
                feats = feats[:, None]
            if feats.shape[0] != n:
                raise ValueError(f"feats must have {n} rows, got {tuple(feats.shape)}")
            if feat_names is not None and len(feat_names) != feats.shape[1]:
                raise ValueError(
                    f"{len(feat_names)} feat_names for {feats.shape[1]} feature columns"
                )
            feats_p = torch.cat(
                [feats, torch.zeros((pad, feats.shape[1]), dtype=torch.float32, device=device)]
            )
        return cls(xyz=xyz_p, mask=mask, normals=nrm_p, covs=cov_p, feats=feats_p,
                   feat_names=tuple(feat_names) if feat_names else None)

    def replace(self, **changes) -> "PointCloud":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "PointCloud":
        def move(x):
            return None if x is None else x.to(device)

        return PointCloud(xyz=self.xyz.to(device), mask=self.mask.to(device),
                          normals=move(self.normals), covs=move(self.covs),
                          feats=move(self.feats), feat_names=self.feat_names)

    # ---- properties --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_valid(self) -> torch.Tensor:
        """Count of real points (0-d int tensor on the cloud's device)."""
        return self.mask.sum()

    def has_normals(self) -> bool:
        return self.normals is not None

    # ---- transforms --------------------------------------------------------

    def with_xyz(self, xyz: torch.Tensor) -> "PointCloud":
        """New coordinates for valid rows; pad rows keep their sentinel."""
        return self.replace(xyz=torch.where(self.mask[:, None], xyz, self.xyz))

    def with_normals(self, normals: torch.Tensor) -> "PointCloud":
        return self.replace(
            normals=torch.where(self.mask[:, None], normals, torch.zeros_like(normals))
        )

    def pad_to(self, capacity: int) -> "PointCloud":
        """Grow the capacity, keeping the mask and sentinel discipline: new
        rows are PAD_COORD, unmasked, with zero normals and features and
        identity covariances."""
        if capacity < self.capacity:
            raise ValueError("pad_to cannot shrink; use take/compact on host")
        extra = capacity - self.capacity
        if extra == 0:
            return self
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)

        def grow(x, fill):
            return None if x is None else torch.cat([x, fill(x)])

        return PointCloud(
            xyz=torch.cat([self.xyz, torch.full((extra, 3), PAD_COORD, **f32)]),
            mask=torch.cat([self.mask, torch.zeros((extra,), dtype=torch.bool, device=dev)]),
            normals=grow(self.normals, lambda x: torch.zeros((extra, 3), **f32)),
            covs=grow(self.covs, lambda x: torch.eye(3, **f32).expand(extra, 3, 3)),
            feats=grow(self.feats, lambda x: torch.zeros((extra, x.shape[1]), **f32)),
            feat_names=self.feat_names,
        )

    def centroid(self) -> torch.Tensor:
        """Masked mean of valid points, (3,)."""
        w = self.mask.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        return (self.xyz * w[:, None]).sum(0) / denom

    def extent(self) -> torch.Tensor:
        """Bounding-box diagonal length over valid points."""
        m = self.mask[:, None]
        lo = torch.where(m, self.xyz, PAD_COORD).amin(0)
        hi = torch.where(m, self.xyz, -PAD_COORD).amax(0)
        diag = torch.linalg.vector_norm(hi - lo)
        return torch.where(self.mask.any(), diag, torch.zeros_like(diag))

    # ---- host-side helpers -------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Valid points only, host numpy (n, 3)."""
        mask = self.mask.cpu().numpy()
        return self.xyz.cpu().numpy()[mask]

    def normals_to_numpy(self) -> Optional[np.ndarray]:
        if self.normals is None:
            return None
        mask = self.mask.cpu().numpy()
        return self.normals.cpu().numpy()[mask]

    def feat(self, name: str) -> torch.Tensor:
        """One named payload column, (N,) in padded layout."""
        if self.feats is None or self.feat_names is None:
            raise KeyError(f"cloud has no payload features (want {name!r})")
        if name not in self.feat_names:
            raise KeyError(f"no feature {name!r}; have {list(self.feat_names)}")
        return self.feats[:, self.feat_names.index(name)]

    def feats_to_numpy(self) -> Optional[np.ndarray]:
        if self.feats is None:
            return None
        mask = self.mask.cpu().numpy()
        return self.feats.cpu().numpy()[mask]


def concat(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (capacity adds; masks preserved)."""
    if (a.normals is None) != (b.normals is None):
        raise ValueError("both clouds must agree on having normals")
    if (a.covs is None) != (b.covs is None):
        raise ValueError("both clouds must agree on having covariances")
    if (a.feats is None) != (b.feats is None) or a.feat_names != b.feat_names:
        raise ValueError("both clouds must agree on payload features")

    def cat(x, y):
        return None if x is None else torch.cat([x, y])

    return PointCloud(xyz=cat(a.xyz, b.xyz), mask=cat(a.mask, b.mask),
                      normals=cat(a.normals, b.normals), covs=cat(a.covs, b.covs),
                      feats=cat(a.feats, b.feats), feat_names=a.feat_names)
