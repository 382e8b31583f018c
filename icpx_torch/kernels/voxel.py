"""Voxel helpers; this slice needs only `auto_cell_size`.

Mirrors `icpx/kernels/voxel.py::auto_cell_size`, which sets the search
radius of the block-path normals. The voxel grid, voxel downsampling and
the hash-probe NN wait for ROADMAP queue 1 step 6.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from icpx_torch.cloud import PAD_COORD
from icpx_torch.kernels.knn import knn


def _nanmedian_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of x over valid entries, the mean of the two middle values
    for an even count (as `jnp.nanmedian`; `torch.nanmedian` returns the
    lower one); NaN when nothing is valid. No host sync."""
    vals = torch.sort(torch.where(valid, x, float("inf"))).values
    cnt = valid.sum()
    lo = vals[torch.clamp((cnt - 1) // 2, min=0)]
    hi = vals[torch.clamp(cnt // 2, max=x.shape[0] - 1)]
    med = 0.5 * lo + 0.5 * hi
    return torch.where(cnt > 0, med, float("nan"))


def auto_cell_size(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                   sample: int = 1024, scale: float = 3.0) -> torch.Tensor:
    """`scale` x the median NN spacing of a strided sample of `sample`
    points, corrected by sqrt(stride) for the sample's sparsity (surface
    data); a 0-d tensor on the points' device."""
    n = xyz.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    stride = max(n // sample, 1)
    sub_mask = mask[::stride][:sample]
    sub = torch.where(sub_mask[:, None], xyz[::stride][:sample], PAD_COORD)
    # 2-NN within the sample = the nearest non-self neighbour
    d2, _ = knn(sub, sub, 2, ref_mask=sub_mask, tile_q=1024, tile_r=1024)
    d = torch.sqrt(torch.clamp(d2[:, 1], min=0.0))
    spacing = _nanmedian_valid(d, sub_mask) / max(math.sqrt(float(stride)), 1.0)
    return torch.clamp(scale * spacing, min=1e-6)
