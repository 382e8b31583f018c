"""Exact 1-NN: the hand-written CUDA kernel and its plain PyTorch version.

The kernel (`csrc/nn.cu`) replaces the Pallas
`icpx/kernels/knn_pallas.py::_nn_kernel`. It is built at first use by
`cuda_build` (plain `nvcc`, a C entry point, `ctypes`). It screens pairs in
the expansion form and rescores the few groups that pass in the direct
form; `screen_margin` is the proven margin of that screen and `plan` the
split of the references across blocks (see the source note).

Contract of both versions: ``(d2 (Nq,) f32, idx (Nq,) i32)`` with the exact
fp32 squared distance to the nearest VALID reference row, in the direct
form ((dx^2 + dy^2) + dz^2); masked rows never win; exact ties go to the
lowest reference index; a query with no valid reference gets ``d2 = +inf``
and index 0. The kernel's output is bit-equal to the plain version's. This
is the JAX package's off-TPU contract (`icpx/kernels/knn.py:180-189`). The
TPU kernel differs in two places: its lane/chunk fold can return a higher
index among exact ties, and a query with no valid reference gets ~3e16 (the
PAD_COORD sentinel distance) instead of inf.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from icpx_torch.kernels import cuda_build
from icpx_torch.utils import profiling


class KernelShape(NamedTuple):
    """The search kernel's constants, as the built library reports them."""

    threads: int  # threads of a search block
    queries_per_thread: int
    group: int  # references screened per group
    tile_r: int  # packed reference rows a block stages at a time


_lib: Optional[ctypes.CDLL] = None
_shape: Optional[KernelShape] = None
_OCCUPANCY: Dict[int, Tuple[int, int]] = {}  # by device index


def library_path():
    """Where the built library for the current sources lives."""
    return cuda_build.library_path("nn")


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library, and read
    its search shape."""
    global _lib, _shape
    if _lib is not None:
        return _lib
    lib = cuda_build.load("nn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.icpx_nn_forward.argtypes = [p, p, p, i, i, p, ll, i, p, p, i, p]
    lib.icpx_nn_forward.restype = i
    lib.icpx_nn_scratch_bytes.argtypes = [i, i]
    lib.icpx_nn_scratch_bytes.restype = ll
    lib.icpx_nn_blocks_per_sm.argtypes = [i]
    lib.icpx_nn_blocks_per_sm.restype = i
    lib.icpx_nn_shape.argtypes = [ctypes.POINTER(i)] * 4
    lib.icpx_nn_shape.restype = None
    vals = [i() for _ in range(4)]
    lib.icpx_nn_shape(*map(ctypes.byref, vals))
    _shape = KernelShape(*(v.value for v in vals))
    _lib = lib
    return lib


def kernel_shape() -> KernelShape:
    """The built search kernel's shape."""
    build()
    return _shape


def screen_margin(qq: torch.Tensor, rr_max: torch.Tensor) -> torch.Tensor:
    """delta_q of the kernel's screen, in float32 as the kernel computes it:
    2^-19 (|q| + R)^2 from |q|^2 and R^2 = the largest |r|^2 over the valid
    rows. Twice a bound (16 u (|q| + R)^2, u = 2^-24) on |s + |q|^2 - d| for
    every pair, s the fp32 screen score and d the fp32 direct form; the
    source note of `csrc/nn.cu` gives the argument (the error is at most
    ~11 u (|q| + R)^2, with the FMA chain or with every product rounded)."""
    total = torch.sqrt(qq.to(torch.float32)) + torch.sqrt(rr_max.to(torch.float32))
    return (2.0 ** -19) * (total * total)


def plan(nq: int, nr: int, sms: int, blocks_per_sm: int,
         shape: KernelShape) -> Tuple[int, int, int]:
    """(query blocks, reference splits, tiles a split) of one search launch
    of a kernel of `shape`: as many splits of the reference tiles as keep
    the grid within one wave of resident blocks (sms x blocks_per_sm), at
    least one, at most one a tile."""
    q_blocks = max(1, math.ceil(nq / (shape.threads * shape.queries_per_thread)))
    tiles = max(1, math.ceil(nr / shape.tile_r))
    splits = min(tiles, max(1, (sms * blocks_per_sm) // q_blocks))
    per_split = math.ceil(tiles / splits)
    return q_blocks, math.ceil(tiles / per_split), per_split


def _occupancy(index: int) -> Tuple[int, int]:
    """(SMs, resident search blocks an SM) of CUDA device `index`, queried
    once."""
    if index not in _OCCUPANCY:
        n = build().icpx_nn_blocks_per_sm(index)
        if n <= 0:
            cuda_build.check(build(), -n, "nn occupancy query")
            raise RuntimeError("nn search kernel: no block fits on an SM")
        _OCCUPANCY[index] = (torch.cuda.get_device_properties(index).multi_processor_count, n)
    return _OCCUPANCY[index]


@functools.lru_cache(maxsize=64)
def _launch_args(index: int, nq: int, nr: int) -> Tuple[int, int]:
    """(tiles a split, scratch bytes) of a call on device `index`."""
    _, _, per_split = plan(nq, nr, *_occupancy(index), kernel_shape())
    return per_split, build().icpx_nn_scratch_bytes(nq, nr)


def launch_plan(nq: int, nr: int, device: torch.device) -> Dict[str, int]:
    """The plan `nn_cuda` launches with on `device`, with the figures and
    the kernel shape it comes from."""
    index = torch.device(device).index or 0
    sms, per_sm = _occupancy(index)
    shape = kernel_shape()
    q_blocks, splits, per_split = plan(nq, nr, sms, per_sm, shape)
    return dict(shape._asdict(), q_blocks=q_blocks, splits=splits, tiles_per_split=per_split,
                sms=sms, blocks_per_sm=per_sm)


def _check_points(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be (n, 3), got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name} has too many rows for int32 indices")


def nn_cuda(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA 1-NN kernels (pack, search) on PyTorch's current stream;
    counts one call in `profiling.LAUNCHES["nn"]` (one call launches two
    kernels, pack and search, and counts once)."""
    if not query.is_cuda:
        raise ValueError("nn_cuda needs CUDA tensors")
    _check_points("query", query, query.device)
    _check_points("ref", ref, query.device)
    nq, nr = query.shape[0], ref.shape[0]
    if ref_mask is not None:
        if ref_mask.dtype != torch.bool or tuple(ref_mask.shape) != (nr,):
            raise ValueError(f"ref_mask must be bool ({nr},), got "
                             f"{ref_mask.dtype} {tuple(ref_mask.shape)}")
        if ref_mask.device != query.device or not ref_mask.is_contiguous():
            raise ValueError("ref_mask must be contiguous and on the query's device")
    lib = build()
    dev = query.device
    per_split, n_scratch = _launch_args(dev.index or 0, nq, nr)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev)
    d = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    rc = lib.icpx_nn_forward(
        query.data_ptr(), ref.data_ptr(),
        None if ref_mask is None else ref_mask.data_ptr(),
        nq, nr, scratch.data_ptr(), n_scratch, per_split,
        d.data_ptr(), idx.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, rc, "nn kernel")
    profiling.LAUNCHES["nn"] += 1
    return d, idx


def nearest_neighbor_reference(
    query: torch.Tensor,
    ref: torch.Tensor,
    *,
    ref_mask: Optional[torch.Tensor] = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version (any device), same contract and
    the same direct (q - r)^2 score, tiled over (query, ref) blocks."""
    nq, nr = query.shape[0], ref.shape[0]
    dev = query.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    d_out, i_out = [], []
    for q0 in range(0, nq, tile_q):
        q = query[q0 : q0 + tile_q]
        best_d = torch.full((q.shape[0],), float("inf"), dtype=torch.float32, device=dev)
        best_i = torch.zeros((q.shape[0],), dtype=torch.int64, device=dev)
        for r0 in range(0, nr, tile_r):
            r = ref[r0 : r0 + tile_r]
            dx = q[:, 0:1] - r[None, :, 0]
            dy = q[:, 1:2] - r[None, :, 1]
            dz = q[:, 2:3] - r[None, :, 2]
            d = dx * dx + dy * dy + dz * dz
            if ref_mask is not None:
                d = torch.where(ref_mask[None, r0 : r0 + tile_r], d, inf)
            dmin, darg = d.min(dim=1)  # first (lowest) index among ties
            better = dmin < best_d
            best_d = torch.where(better, dmin, best_d)
            best_i = torch.where(better, darg + r0, best_i)
        d_out.append(best_d)
        i_out.append(best_i)
    if not d_out:
        return (torch.empty((0,), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    return torch.cat(d_out), torch.cat(i_out).to(torch.int32)
