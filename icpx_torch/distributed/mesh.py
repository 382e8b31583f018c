"""Device-mesh construction for the registration engine.

Mirrors `icpx/distributed/mesh.py`. The named mesh axes are a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, one rank a device; an axis's process group is
`mesh.get_group(axis)`. Axis conventions, as in the reference:

  * ``pairs``  — data parallel over independent scan pairs;
  * ``points`` — the point dimension of one pair (NN and normal-equation
    partials a shard, a 6x6 psum);
  * ``blocks`` — map blocks for scan-to-map (`map_ep`);
  * ``stages`` — pyramid levels (`pipeline`).

The backend is NCCL on the card (one GPU a rank) and gloo on the CPU. The
default group comes from the caller (`init_process_group` with a
`FileStore`), from torchrun's environment (`multihost.init_multihost`),
or, when neither exists, from a one-process group over a `FileStore` in
a temporary directory, as JAX's mesh needs no set-up on one host.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape_for(n_devices: int, n_pairs: Optional[int] = None) -> Tuple[int, int]:
    """Factor n_devices into (pairs, points) mesh dims.

    Gives the pairs axis the largest divisor of n_devices that is at most
    n_pairs and the rest to point sharding; with no batch hint every
    device goes to the points axis (single-pair latency mode)."""
    if n_pairs is None or n_pairs <= 1:
        return (1, n_devices)
    dp = 1
    for d in range(min(n_pairs, n_devices), 0, -1):
        if n_devices % d == 0:
            dp = d
            break
    return (dp, n_devices // dp)


def _init_single(device: torch.device) -> None:
    """A one-process default group over a FileStore in a temporary
    directory (removed at exit)."""
    from icpx_torch.distributed.multihost import init_multihost

    if init_multihost():
        return
    tmp = tempfile.mkdtemp(prefix="icpx_torch_pg_")
    atexit.register(shutil.rmtree, tmp, True)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    atexit.register(_destroy)  # runs first: the group goes before its store


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("pairs", "points"),
    device="cuda",
) -> DeviceMesh:
    """A mesh of `shape` over every rank of the default group, on `device`
    ("cuda" unless the caller asks for "cpu").

    `shape=None` puts every rank on the last axis. Without a CUDA device,
    `device="cuda"` raises: no path falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (torch.cuda.is_available() is false); "
                           "pass device='cpu' to build a gloo mesh on the CPU")
    if not dist.is_initialized():
        _init_single(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names {tuple(axis_names)}")
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
