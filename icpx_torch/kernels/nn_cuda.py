"""Exact 1-NN: the hand-written CUDA kernel and its plain PyTorch version.

The kernel (`csrc/nn.cu`) replaces the Pallas
`icpx/kernels/knn_pallas.py::_nn_kernel`. It is built at first use by
`cuda_build` (plain `nvcc`, a C entry point, `ctypes`).

Contract of both versions: ``(d2 (Nq,) f32, idx (Nq,) i32)`` with the exact
fp32 squared distance to the nearest VALID reference row; masked rows never
win; exact ties go to the lowest reference index; a query with no valid
reference gets ``d2 = +inf`` and index 0. This is the JAX package's off-TPU
contract (`icpx/kernels/knn.py:180-189`). The TPU kernel differs in two
places: its lane/chunk fold can return a higher index among exact ties,
and a query with no valid reference gets ~3e16 (the PAD_COORD sentinel
distance) instead of inf.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icpx_torch.kernels import cuda_build

# Launches of the CUDA kernel in this process: `nn_cuda` adds one per
# launch and nothing else touches it, so a caller can show that a run went
# through the kernel (reset it to 0, run, read it).
LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None


def library_path():
    """Where the built library for the current sources lives."""
    return cuda_build.library_path("nn")


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("nn")
    lib.icpx_nn_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.icpx_nn_forward.restype = ctypes.c_int
    _lib = lib
    return lib


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
    """Launch the CUDA 1-NN kernel on PyTorch's current stream."""
    global LAUNCHES
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
    d = torch.empty((nq,), dtype=torch.float32, device=query.device)
    idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.icpx_nn_forward(
        query.data_ptr(), ref.data_ptr(),
        None if ref_mask is None else ref_mask.data_ptr(),
        nq, nr, d.data_ptr(), idx.data_ptr(), query.device.index, stream,
    )
    cuda_build.check(lib, rc, "nn kernel")
    LAUNCHES += 1
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
