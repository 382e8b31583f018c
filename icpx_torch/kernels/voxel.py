"""Voxel-hash nearest neighbour and the cell-size heuristic.

Mirrors `icpx/kernels/voxel.py`, which is XLA in the reference, so plain
torch here on every device. `build_voxel_grid` hashes integer cell
coordinates into a power-of-two table of buckets (stable sort by key, the
rank within each run of equal keys from a running maximum, the first
`bucket_size` ranks scattered into a dense (H, B) table); `voxel_nn` probes
the 27 neighbour cells of each query. `auto_cell_size` also sets the
search radius of the block-path normals.

The int32 hash wraps as XLA's does: the products and XORs are taken in
int64 and only the low bits survive the mask `& (H - 1)`, which are the
wrapped int32's. Pad rows' cell coordinates overflow int32 (their
conversion is not defined the same way on every device); the build gives
their keys the out-of-range H anyway, and a pad query row may probe any
bucket.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from icpx_torch.cloud import PAD_COORD
from icpx_torch.kernels.knn import knn
from icpx_torch.utils import profiling

# Large primes for the 3D spatial hash (Teschner et al. 2003).
_P1, _P2, _P3 = 73856093, 19349663, 83492791

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Hashed voxel index over a fixed reference cloud."""

    ref_xyz: torch.Tensor  # (N, 3) reference coordinates, original order
    table: torch.Tensor  # (H, B) int32 point indices, -1 = empty
    origin: torch.Tensor  # (3,)
    inv_cell: torch.Tensor  # 0-d, 1 / cell size

    @property
    def n_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.table.shape[1]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _cells(xyz: torch.Tensor, origin: torch.Tensor, inv_cell: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 cell coordinates floor((x - origin) / h)."""
    return torch.floor((xyz - origin) * inv_cell).to(torch.int32)


def _hash_cells(cells: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(N, 3) int32 cell coordinates -> (N,) int64 bucket ids in [0, n_buckets):
    the reference's wrapped int32 hash, whose low bits the int64 products
    keep."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & (n_buckets - 1)


def build_voxel_grid(xyz: torch.Tensor, cell_size, mask: Optional[torch.Tensor] = None, *,
                     bucket_size: int = 16, table_factor: int = 2) -> VoxelGrid:
    """Hash grid over (N, 3) reference points: H = table_factor * N
    rounded up to a power of two buckets of `bucket_size` slots; a
    bucket's overflow is dropped, masked rows never enter."""
    n = xyz.shape[0]
    dev = xyz.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    H = _next_pow2(max(table_factor * n, 16))
    inv_h = 1.0 / torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    origin = torch.where(mask[:, None], xyz, PAD_COORD).amin(0)

    keys = torch.where(mask, _hash_cells(_cells(xyz, origin, inv_h), H), H)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    # rank within a run of equal keys: i - (the run's first index), the
    # first index a running maximum over run starts
    idx = torch.arange(n, device=dev)
    is_first = torch.ones((n,), dtype=torch.bool, device=dev)
    is_first[1:] = sk[1:] != sk[:-1]
    first_pos = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = idx - first_pos
    # the reference scatters with mode="drop": out-of-range slots are left out
    keep = (rank < bucket_size) & (sk < H)
    table = torch.full((H * bucket_size,), -1, dtype=torch.int32, device=dev)
    table[(sk * bucket_size + rank)[keep]] = order[keep].to(torch.int32)
    return VoxelGrid(ref_xyz=xyz, table=table.reshape(H, bucket_size), origin=origin,
                     inv_cell=inv_h)


def voxel_nn(query: torch.Tensor, grid: VoxelGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """NN of (Nq, 3) queries among the grid's reference points over the 27
    cells around each query: (sqdist (Nq,), int32 index (Nq,)); (inf, 0)
    where no candidate is found. Ties go to the earliest probe, then the
    lowest slot."""
    nq = query.shape[0]
    dev = query.device
    qcells = _cells(query, grid.origin, grid.inv_cell).to(torch.int64)
    best_d = torch.full((nq,), float("inf"), device=dev)
    best_i = torch.zeros((nq,), dtype=torch.int32, device=dev)
    for off in _OFFSETS:
        keys = _hash_cells(qcells + torch.tensor(off, device=dev), grid.n_buckets)
        cand = grid.table[keys]  # (Nq, B)
        cxyz = grid.ref_xyz[torch.clamp(cand, min=0).long()]  # (Nq, B, 3)
        diff = query[:, None, :] - cxyz
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        d = torch.where(cand >= 0, d, float("inf"))
        dmin, darg = d.min(dim=1)
        better = dmin < best_d
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, torch.gather(cand, 1, darg[:, None])[:, 0], best_i)
    return best_d, best_i


def _nanmedian_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of x over valid entries, the mean of the two middle values
    for an even count (as `jnp.nanmedian`; `torch.nanmedian` returns the
    lower one); NaN when nothing is valid. The two middle ranks are read on
    the host (`profiling.fetch_int`), as indexing by a 0-d tensor reads it."""
    vals = torch.sort(torch.where(valid, x, float("inf"))).values
    cnt = valid.sum()
    lo = vals[profiling.fetch_int(torch.clamp((cnt - 1) // 2, min=0))]
    hi = vals[profiling.fetch_int(torch.clamp(cnt // 2, max=x.shape[0] - 1))]
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
