"""Multi-host bring-up on `torch.distributed`.

Mirrors `icpx/distributed/multihost.py`. The reference wires its hosts
with `jax.distributed.initialize`; here the process group is set up from
torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
`RANK`, `LOCAL_RANK`) or explicit arguments, one process a GPU, NCCL on
the cards (gloo without one). A process with none of that is a single
process and nothing is initialized, as JAX does on one host; everything
in `icpx_torch.distributed` works the same on one rank, since mesh axes
are the only abstraction the algorithms see.

    torchrun --nproc_per_node 4 my_script.py   # one rank per GPU
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize the default process group when running as one of several
    processes; returns True if there is one (already or now).

    `coordinator_address` is "host:port" (default MASTER_ADDR:MASTER_PORT),
    `num_processes` the world size (WORLD_SIZE), `process_id` this rank
    (RANK), `local_rank` its GPU on this host (LOCAL_RANK, else the rank
    modulo the host's GPU count). The backend defaults to NCCL when a GPU
    is visible, else gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    num = num_processes or _env_int("WORLD_SIZE")
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    pid = process_id if process_id is not None else _env_int("RANK")
    if addr is None and num is None:
        return False
    if addr is None or num is None or pid is None:
        raise ValueError("multi-process bring-up needs an address, a world size and a rank "
                         f"(got {addr!r}, {num!r}, {pid!r})")
    use_cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if use_cuda else "gloo")
    if use_cuda:
        lr = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
        torch.cuda.set_device(lr if lr is not None else pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num, rank=pid)
    return True


def _local_world() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun), else every rank."""
    return _env_int("LOCAL_WORLD_SIZE") or dist.get_world_size()


def global_mesh(axis_names: Sequence[str] = ("hosts", "points"), device="cuda"):
    """A mesh over every rank: first axis the hosts, the second each host's
    local ranks (one axis over all ranks when one name is given)."""
    from icpx_torch.distributed.mesh import make_mesh

    if not dist.is_initialized():
        return make_mesh(None, axis_names, device=device)
    n = dist.get_world_size()
    local = _local_world()
    shape = (n // local, local) if len(axis_names) == 2 else (n,)
    return make_mesh(shape, axis_names, device=device)


def host_local_shard(array: np.ndarray, axis: int = 0) -> np.ndarray:
    """This host's contiguous slice of a host-sharded numpy array (data
    loading: each host reads only its shard of the scan list or rows)."""
    if dist.is_initialized():
        local = _local_world()
        pc, pid = dist.get_world_size() // local, dist.get_rank() // local
    else:
        pc, pid = 1, 0
    n = array.shape[axis]
    per = n // pc
    sl = [slice(None)] * array.ndim
    sl[axis] = slice(pid * per, (pid + 1) * per)
    return array[tuple(sl)]
