"""Background scan prefetching: overlap file reads and native parsing with
device work.

Mirrors `icpx/io/prefetch.py`. Sequential odometry alternates [load scan
k+1] -> [register scan k+1]; the load is file IO plus the native parser,
both of which release the GIL, so a small thread pool keeps `depth` scans
decoded ahead while the card registers the current one.
"""

from __future__ import annotations

import concurrent.futures as _fut
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

from icpx_torch.cloud import DEFAULT_DEVICE, PointCloud


class ScanPrefetcher:
    """Iterate PointClouds from `paths` in order, keeping `depth` loads in
    flight.

    `loader(path) -> PointCloud` defaults to `load_cloud` at a fixed
    `capacity` (one capacity = one set of shapes downstream) on `device`.
    Supports len() and iteration.
    """

    def __init__(
        self,
        paths: Sequence,
        *,
        capacity: int,
        depth: int = 3,
        loader: Optional[Callable] = None,
        device=DEFAULT_DEVICE,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.paths = [Path(p) for p in paths]
        self.capacity = capacity
        self.depth = depth
        if loader is None:
            from icpx_torch.io.loaders import load_cloud

            def loader(p):
                return load_cloud(p, capacity=capacity, device=device)
        self._loader = loader

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[PointCloud]:
        if not self.paths:
            return
        with _fut.ThreadPoolExecutor(max_workers=self.depth) as pool:
            pending = {}
            n = len(self.paths)
            head = 0
            for k in range(n):
                # top up the pipeline to `depth` loads in flight
                while head < n and head - k < self.depth:
                    pending[head] = pool.submit(self._loader, self.paths[head])
                    head += 1
                yield pending.pop(k).result()


def prefetch_kitti(
    velodyne_dir,
    *,
    capacity: int,
    max_frames: Optional[int] = None,
    depth: int = 3,
    with_intensity: bool = False,
    device=DEFAULT_DEVICE,
) -> ScanPrefetcher:
    """Streaming KITTI ingest: the directory's velodyne .bin files decoded
    ahead of use (the native reader; reflectance kept as a "reflectance"
    feature column when `with_intensity`), as clouds on `device`."""
    from icpx_torch.odometry.kitti import load_kitti_scan, load_kitti_scan_xyzi

    files = sorted(Path(velodyne_dir).glob("*.bin"))
    if max_frames is not None:
        files = files[:max_frames]

    def loader(p):
        if with_intensity:
            arr = load_kitti_scan_xyzi(p)[:capacity]
            return PointCloud.create(arr[:, :3], capacity=capacity, feats=arr[:, 3:4],
                                     feat_names=("reflectance",), device=device)
        return PointCloud.create(load_kitti_scan(p)[:capacity], capacity=capacity,
                                 device=device)

    return ScanPrefetcher(files, capacity=capacity, depth=depth, loader=loader)
