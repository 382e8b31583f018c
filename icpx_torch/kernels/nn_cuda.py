"""Exact 1-NN: the hand-written CUDA kernel and its plain PyTorch version.

The kernel (`csrc/nn.cu`) replaces the Pallas
`icpx/kernels/knn_pallas.py::_nn_kernel`. It is built at first use by
`cuda_build` (plain `nvcc`, a C entry point, `ctypes`). It screens pairs in
the expansion form and rescores the few groups that pass in the direct
form; `screen_margin` is the proven margin of that screen and `plan` the
work items of a launch (see the source note). Two kinds of rows carry
nothing for the screen, and the kernel finds both in its own inputs:
reference tiles with no valid row are skipped, and far query rows
(`far_rows`: every group of theirs would pass the screen, as for rows at
PAD_COORD) are scored in the direct form alone, in pieces spread over the
card. `path_counts` gives what the kernel adds to
`profiling.nn_counters` for a call.

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
    lib.icpx_nn_forward.argtypes = [p, p, p, i, i, p, ll, i, i, p, p, p, i, p]
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


def far_rows(query: torch.Tensor, rr_max: torch.Tensor) -> torch.Tensor:
    """The query rows the kernel scores in the direct form alone, as it
    finds them in float32: delta_q (`screen_margin`) >= R (R + 4 |q|), R^2
    = `rr_max` the largest |r|^2 over the valid rows. The screen scores
    |r|^2 - 2 q.r of such a row lie in [-2 |q| R, R^2 + 2 |q| R], so each
    of its groups would pass. Rows at PAD_COORD are far; a row in or near
    the references is not. Which rows are far decides only where the kernel
    spends its time, never its answers."""
    q = query.to(torch.float32)
    qq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    big_r = torch.sqrt(rr_max.to(torch.float32))
    return screen_margin(qq, rr_max) >= big_r * (big_r + 4.0 * torch.sqrt(qq))


def path_counts(query: torch.Tensor, ref: torch.Tensor, ref_mask: Optional[torch.Tensor],
                shape: KernelShape) -> Tuple[int, int]:
    """(far rows, empty tiles skipped) that one call of a kernel of `shape`
    adds to `profiling.nn_counters`: the far rows when any reference row is
    valid (none otherwise), and every query block skips each tile of
    `shape.tile_r` reference rows that holds no valid row."""
    nr = ref.shape[0]
    valid = torch.ones(nr, dtype=torch.bool) if ref_mask is None else ref_mask.cpu()
    tiles = math.ceil(nr / shape.tile_r)
    per_tile = torch.zeros(tiles * shape.tile_r, dtype=torch.bool)
    per_tile[:nr] = valid
    empty = tiles - int(per_tile.reshape(tiles, shape.tile_r).any(1).sum())
    q_blocks = math.ceil(query.shape[0] / (shape.threads * shape.queries_per_thread))
    if not bool(valid.any()):
        return 0, empty * q_blocks
    r = ref.cpu()[valid].to(torch.float32)
    rr = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
    return int(far_rows(query.cpu(), rr.max()).sum()), empty * q_blocks


def plan(nq: int, nr: int, sms: int, blocks_per_sm: int,
         shape: KernelShape) -> Tuple[int, int, int]:
    """(query blocks, reference splits, grid blocks) of one search launch of
    a kernel of `shape`: as many splits of the reference tiles as keep the
    near work items (query block, split) within one wave of resident
    blocks (sms x blocks_per_sm), at least one, at most one a tile; the
    grid is two blocks a near item, at most that wave. Its blocks take the
    near and then the far items from a counter, so the blocks beyond the
    near items start on far rows while the near items run."""
    q_blocks = max(1, math.ceil(nq / (shape.threads * shape.queries_per_thread)))
    tiles = max(1, math.ceil(nr / shape.tile_r))
    wave = sms * blocks_per_sm
    splits = min(tiles, max(1, wave // q_blocks))
    return q_blocks, splits, min(wave, 2 * q_blocks * splits)


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
def _launch_args(index: int, nq: int, nr: int) -> Tuple[int, int, int]:
    """(splits, grid blocks, scratch bytes) of a call on device `index`."""
    _, splits, grid = plan(nq, nr, *_occupancy(index), kernel_shape())
    return splits, grid, build().icpx_nn_scratch_bytes(nq, nr)


def launch_plan(nq: int, nr: int, device: torch.device) -> Dict[str, int]:
    """The plan `nn_cuda` launches with on `device`, with the figures and
    the kernel shape it comes from."""
    index = torch.device(device).index or 0
    sms, per_sm = _occupancy(index)
    shape = kernel_shape()
    q_blocks, splits, grid = plan(nq, nr, sms, per_sm, shape)
    return dict(shape._asdict(), q_blocks=q_blocks, splits=splits, grid=grid, sms=sms,
                blocks_per_sm=per_sm)


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
    kernels, pack and search, and counts once), and the kernel adds its far
    rows and skipped empty tiles to `profiling.nn_counters` on the card."""
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
    splits, grid, n_scratch = _launch_args(dev.index or 0, nq, nr)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev)
    d = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    rc = lib.icpx_nn_forward(
        query.data_ptr(), ref.data_ptr(),
        None if ref_mask is None else ref_mask.data_ptr(),
        nq, nr, scratch.data_ptr(), n_scratch, splits, grid,
        profiling.nn_counter_tensor(dev).data_ptr(), d.data_ptr(), idx.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
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
