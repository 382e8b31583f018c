"""Segmented stable sort: the median-level sorts of the KD tile-index build.

One hand-written CUDA kernel (`csrc/sort.cu`, built by `cuda_build`) beside
its plain PyTorch version with the same contract:

* `sort` replaces the Pallas `sort_pallas._sort_kernel` (wrapper
  `sort_segments`): every row of a (c, m) f32 key, m a power of two, sorted
  stably, with payload arrays whose first two dimensions are (c, m) reordered
  alike. The output equals `torch.sort(key, dim=1, stable=True)` followed by
  `take_along_dim` on the key and every payload, for finite keys; signed
  zeros compare equal, as in `torch.sort` and `lax.sort`, and keep their own
  bits. PAD_COORD keys sink to each segment's tail in their original order.

`sort_segments` launches the kernel on a CUDA tensor (or raises) and runs the
plain version on a CPU tensor. `LAUNCHES["sort"]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from icpx_torch.kernels import cuda_build

# Kernel launches in this process: `sort_segments` adds one where it launches
# the kernel (one call sorts every segment), and nowhere else.
LAUNCHES = {"sort": 0}

_MAX_PAYLOADS = 4  # kMaxPayloads in csrc/sort.cu
_SMEM_ELEMS = 16384  # segments longer than this sort through a scratch array
_WORD_TYPES = (torch.float32, torch.int32)

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("sort")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icpx_sort_forward.argtypes = [p, i, i, p, p, p, i, p, p, i, p]
    lib.icpx_sort_forward.restype = i
    _lib = lib
    return lib


def library_path():
    return cuda_build.library_path("sort")


def _check_shapes(key: torch.Tensor, payloads: Sequence[torch.Tensor]) -> Tuple[int, int]:
    if key.ndim != 2:
        raise ValueError(f"key must be (c, m), got {tuple(key.shape)}")
    c, m = key.shape
    if m < 1 or m & (m - 1):
        raise ValueError(f"segment length must be a power of two, got {m}")
    for p in payloads:
        if tuple(p.shape[:2]) != (c, m):
            raise ValueError(f"payload {tuple(p.shape)} does not start with the key's {(c, m)}")
    return c, m


def sort_cuda(key: torch.Tensor, payloads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Launch the sort kernel: (sorted key, *payloads reordered)."""
    c, m = _check_shapes(key, payloads)
    dev = key.device
    if not key.is_cuda:
        raise ValueError("the sort kernel needs CUDA tensors")
    if key.dtype != torch.float32 or not key.is_contiguous():
        raise ValueError("key must be contiguous float32")
    if len(payloads) > _MAX_PAYLOADS:
        raise ValueError(f"at most {_MAX_PAYLOADS} payloads, got {len(payloads)}")
    for p in payloads:
        if p.dtype not in _WORD_TYPES or p.device != dev or not p.is_contiguous():
            raise ValueError(f"payloads must be contiguous float32 or int32 on {dev}, "
                             f"got {p.dtype} on {p.device}")
    if c * m >= 2**31:
        raise ValueError("too many elements for the kernel's int32 segment count")
    lib = build()
    out_key = torch.empty_like(key)
    outs = [torch.empty_like(p) for p in payloads]
    work = torch.empty((c, m), dtype=torch.int64, device=dev) if m > _SMEM_ELEMS else None
    n = len(payloads)
    ins = (ctypes.c_void_p * _MAX_PAYLOADS)(*[p.data_ptr() for p in payloads])
    ptrs = (ctypes.c_void_p * _MAX_PAYLOADS)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * _MAX_PAYLOADS)(*[p[0, 0].numel() if p.numel() else 1 for p in payloads])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.icpx_sort_forward(
        key.data_ptr(), c, m, ctypes.cast(ins, ctypes.c_void_p), ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p), n, out_key.data_ptr(),
        None if work is None else work.data_ptr(), dev.index, stream,
    )
    cuda_build.check(lib, rc, "sort kernel")
    LAUNCHES["sort"] += 1
    return (out_key, *outs)


def sort_segments_reference(key: torch.Tensor,
                            payloads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The sort kernel's plain version, any device: a stable `torch.sort` of
    each row and `take_along_dim` of the key and payloads. The key sorted is
    `key + 0.0`, which turns -0.0 into +0.0, so signed zeros compare equal on
    every backend."""
    _check_shapes(key, payloads)
    perm = torch.sort(key + 0.0, dim=1, stable=True).indices
    outs = [torch.take_along_dim(key, perm, dim=1)]
    for p in payloads:
        idx = perm.reshape(perm.shape + (1,) * (p.ndim - 2))
        outs.append(torch.take_along_dim(p, idx, dim=1))
    return tuple(outs)


def sort_segments(key: torch.Tensor, payloads: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """(sorted key, *payloads reordered): each of the c rows of the (c, m)
    key sorted stably, m a power of two; each payload is (c, m, ...) of
    float32 or int32. The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if key.is_cuda:
        return sort_cuda(key.contiguous(), [p.contiguous() for p in payloads])
    return sort_segments_reference(key, payloads)
