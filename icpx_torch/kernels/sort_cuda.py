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
plain version on a CPU tensor; it adds one to `profiling.LAUNCHES["sort"]`
where it launches the kernel (one call sorts every segment).
`plan` says how a call runs (whole segments in a block, a segment a
cluster pair of blocks, or the chunked path) from the kernel's shape, which
`kernel_shape` reads from the built library.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from icpx_torch.kernels import cuda_build
from icpx_torch.utils import profiling

_WORD_TYPES = (torch.float32, torch.int32)


class KernelShape(NamedTuple):
    """The sort kernel's constants, as the built library reports them."""

    max_payloads: int
    block_elems: int  # packed keys one block sorts in registers
    threads: int  # threads of a block


_lib: Optional[ctypes.CDLL] = None
_shape: Optional[KernelShape] = None


def build() -> ctypes.CDLL:
    """Compile (if the cache misses) and load the kernel library, and read
    its shape."""
    global _lib, _shape
    if _lib is not None:
        return _lib
    lib = cuda_build.load("sort")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icpx_sort_forward.argtypes = [p, i, i, p, p, p, i, p, p, i, p]
    lib.icpx_sort_forward.restype = i
    lib.icpx_sort_shape.argtypes = [ctypes.POINTER(i)] * 3
    lib.icpx_sort_shape.restype = None
    vals = [i() for _ in range(3)]
    lib.icpx_sort_shape(*map(ctypes.byref, vals))
    _shape = KernelShape(*(v.value for v in vals))
    _lib = lib
    return lib


def kernel_shape() -> KernelShape:
    """The built sort kernel's shape."""
    build()
    return _shape


def library_path():
    return cuda_build.library_path("sort")


def plan(c: int, m: int, shape: KernelShape) -> Dict[str, int]:
    """How one call of a kernel of `shape` sorts (c, m): "block" (whole
    segments, block_elems // m to a block), "pair" (a segment of
    2 * block_elems a cluster of two blocks) or "chunked" (longer segments:
    block passes over chunks and device-memory passes, through a (c, m)
    int64 scratch array); its blocks a block pass and its launches."""
    blocks = -(-c * m // shape.block_elems)
    if m <= shape.block_elems:
        return dict(path="block", blocks=blocks, launches=1, work=0)
    if m == 2 * shape.block_elems:
        return dict(path="pair", blocks=blocks, launches=1, work=0)
    merges = (m // shape.block_elems).bit_length() - 1  # merge sizes above a block
    global_passes = merges * (merges + 1) // 2  # partner distances >= block_elems
    return dict(path="chunked", blocks=blocks, launches=1 + merges + global_passes, work=c * m)


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


class _Call(NamedTuple):
    """What a call of one (device, c, m, payload shapes) reuses: the layout
    of its one output allocation (f32 words: the scratch, 2 words an
    element, where the chunked path needs it, then the key, then each
    payload) and the ctypes argument arrays."""

    words: int
    work_words: int
    views: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]  # (shape, stride, offset)
    ins: ctypes.Array
    outs: ctypes.Array
    widths: ctypes.Array


@functools.lru_cache(maxsize=64)
def _call_plan(index: int, c: int, m: int, shapes: Tuple[Tuple[int, ...], ...]) -> _Call:
    k_shape = kernel_shape()
    if len(shapes) > k_shape.max_payloads:
        raise ValueError(f"at most {k_shape.max_payloads} payloads, got {len(shapes)}")
    total = c * m
    widths = [math.prod(sh[2:]) for sh in shapes]
    work_words = 2 * plan(c, m, k_shape)["work"]
    views, at = [], work_words
    for sh in ((c, m), *shapes):
        views.append((sh, torch.empty(sh, device="meta").stride(), at))
        at += math.prod(sh)
    n = k_shape.max_payloads
    return _Call(words=at, work_words=work_words, views=tuple(views),
                 ins=(ctypes.c_void_p * n)(), outs=(ctypes.c_void_p * n)(),
                 widths=(ctypes.c_int * n)(*widths))


def sort_cuda(key: torch.Tensor, payloads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Launch the sort kernel: (sorted key, *payloads reordered)."""
    c, m = _check_shapes(key, payloads)
    dev = key.device
    if not key.is_cuda:
        raise ValueError("the sort kernel needs CUDA tensors")
    if key.dtype != torch.float32 or not key.is_contiguous():
        raise ValueError("key must be contiguous float32")
    for p in payloads:
        if p.dtype not in _WORD_TYPES or p.device != dev or not p.is_contiguous():
            raise ValueError(f"payloads must be contiguous float32 or int32 on {dev}, "
                             f"got {p.dtype} on {p.device}")
    total = c * m
    if total >= 2**31:
        raise ValueError("too many elements for the kernel's int32 indices")
    lib = build()
    call = _call_plan(dev.index or 0, c, m, tuple(tuple(p.shape) for p in payloads))
    buf = torch.empty((call.words,), dtype=torch.float32, device=dev)
    out_key = buf.as_strided(*call.views[0])
    outs = []
    for a, p in enumerate(payloads):
        o = buf.as_strided(*call.views[a + 1])
        outs.append(o if p.dtype == torch.float32 else o.view(p.dtype))
        call.ins[a] = p.data_ptr()
        call.outs[a] = o.data_ptr()
    rc = lib.icpx_sort_forward(
        key.data_ptr(), c, m, ctypes.addressof(call.ins), ctypes.addressof(call.outs),
        ctypes.addressof(call.widths), len(payloads), out_key.data_ptr(),
        buf.data_ptr() if call.work_words else None, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, rc, "sort kernel")
    profiling.LAUNCHES["sort"] += 1
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
