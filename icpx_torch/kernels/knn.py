"""Brute-force nearest-neighbour search.

Mirrors `icpx/kernels/knn.py`:

* `knn` — tiled exact top-k, plain PyTorch on every device (XLA-only in
  the JAX package too). Ties are broken by the lower reference index, as
  `lax.top_k` does: each candidate is scored by one int64 key whose high
  word is the fp32 distance's bit pattern (monotone for d >= 0) and whose
  low word is the reference index, so the k smallest keys are the k
  nearest points in (distance, index) order.
* `nearest_neighbor` — the k=1 path the ICP loop calls each iteration.
  On a CUDA tensor it launches the hand-written kernel (`nn_cuda.nn_cuda`);
  on a CPU tensor it runs the kernel's plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icpx_torch.kernels import nn_cuda
from icpx_torch.kernels.nn_cuda import nearest_neighbor_reference

__all__ = ["pairwise_sqdist", "knn", "nearest_neighbor", "nearest_neighbor_reference"]

_LOW32 = 0xFFFFFFFF


def pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Nq, 3) x (Nr, 3) -> (Nq, Nr) squared distances by the expansion
    ||q||^2 + ||r||^2 - 2 q.r (as the JAX package), clamped at 0."""
    qq = (q * q).sum(-1, keepdim=True)
    rr = (r * r).sum(-1, keepdim=True).T
    return torch.clamp(qq + rr - 2.0 * (q @ r.T), min=0.0)


def _keys(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | idx


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    k: int,
    *,
    ref_mask: Optional[torch.Tensor] = None,
    tile_q: int = 1024,
    tile_r: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query among ref points.

    Returns (sqdists (Nq, k) ascending, indices (Nq, k) int32 into ref).
    Masked refs are never returned with a finite distance; slots without
    a valid neighbour hold (inf, 0), as in the JAX package.
    """
    nq, nr = query.shape[0], ref.shape[0]
    if k > nr:
        raise ValueError(f"k={k} > number of reference points {nr}")
    dev = query.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    # (inf, index 0): what the reference's running top-k starts from
    init = _keys(inf.expand(1), torch.zeros(1, dtype=torch.int64, device=dev))
    out = []
    for q0 in range(0, nq, tile_q):
        q = query[q0 : q0 + tile_q]
        best = init.expand(q.shape[0], k)
        for r0 in range(0, nr, tile_r):
            r = ref[r0 : r0 + tile_r]
            d = pairwise_sqdist(q, r)
            if ref_mask is not None:
                d = torch.where(ref_mask[None, r0 : r0 + tile_r], d, inf)
            idx = torch.arange(r0, r0 + r.shape[0], device=dev)
            cand = torch.topk(_keys(d, idx[None, :]), min(k, r.shape[0]),
                              dim=1, largest=False).values
            best = torch.topk(torch.cat([best, cand], dim=1), k,
                              dim=1, largest=False).values
        out.append(best)
    keys = torch.cat(out) if out else init.expand(0, k)
    d_out = (keys >> 32).to(torch.int32).view(torch.float32)
    i_out = (keys & _LOW32).to(torch.int32)
    return d_out, i_out


def nearest_neighbor(
    query: torch.Tensor,
    ref: torch.Tensor,
    *,
    ref_mask: Optional[torch.Tensor] = None,
    tile_q: int = 2048,
    tile_r: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour: (sqdist (Nq,), index (Nq,) int32).

    CUDA tensors go to the CUDA kernel (the tile arguments do not apply
    to it); CPU tensors to the plain version, tiled by tile_q x tile_r.
    """
    if query.is_cuda:
        mask = None if ref_mask is None else ref_mask.contiguous()
        return nn_cuda.nn_cuda(query.contiguous(), ref.contiguous(), mask)
    return nearest_neighbor_reference(
        query, ref, ref_mask=ref_mask, tile_q=tile_q, tile_r=tile_r
    )
