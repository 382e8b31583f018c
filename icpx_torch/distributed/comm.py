"""The distributed layer's collectives, on `torch.distributed`.

The reference never names a collective library: XLA emits every collective
from `lax.psum`, `lax.ppermute` and `lax.all_to_all` inside `shard_map`.
Here each of those is one function over a process group (a mesh axis's
group, `mesh.get_group(axis)`), and every rank calls the same entry point
with the same global inputs, as a JAX caller passes global arrays:

  * `psum(tree, group)`: the sum of every leaf over the group, in one flat
    `all_reduce(SUM)` a dtype, as XLA combines a tuple psum;
  * `Permute` / `permute(tensors, group, perm)`: `lax.ppermute`, by
    `batch_isend_irecv`; a rank that receives nothing gets zeros.
    `ring_shift(tensors, group)` posts the ring's shift, send to rank - 1
    and receive from rank + 1 (the reference's `perm = [(j, (j - 1) % n)]`),
    so at ring step s rank r holds shard (r + s) % W; the caller posts it
    before the step's fold and waits on it after;
  * `all_to_all(x, group)`: `all_to_all_single` with equal splits along
    dim 0, in the chunk order of `lax.all_to_all(x, axis, 0, 0,
    tiled=False)`;
  * `all_gather(tree, group)`: every leaf concatenated along dim 0 in rank
    order (the port's replicated form of a result the reference leaves
    sharded, `out_specs=P(axis)`);
  * `axis_index`, `axis_size` and `shard` over a group (an axis's group is
    `mesh.get_group(axis)`).

Each collective is written into the per-process record while one is open
(`recording()`): its kind under XLA's opcode names (`all-reduce`,
`collective-permute`, `all-to-all`, `all-gather`), its bytes a rank and the
function that issued it; a permute's post and wait, and each ring fold
(`note_fold`), are events of their own, so `utils.collectives` can check
that a shift was posted before the fold it hides behind and waited on
after it.

Backends. NCCL gets the card's tensors as they are. Gloo takes CPU
tensors for every op, but of CUDA tensors only `all_reduce`: for the
other ops (P2P, all-to-all, all-gather) under gloo a CUDA tensor is copied
to host memory around that op and the result copied back. Nothing else
moves off the device. Bool tensors travel as uint8 (gloo has no bool).
At a group size of 1 a permute sends nothing (torch refuses a send to
self): the tensors stay where they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from icpx_torch.utils import pytree

# what gloo takes as CUDA tensors; every other op goes through host memory
_GLOO_DEVICE_OPS = frozenset({"all_reduce"})
# a flat all-gather into one tensor, under its name in this torch version
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass
class Event:
    """One entry of the collective record."""

    kind: str  # "all-reduce" | "collective-permute" | "all-to-all" | "all-gather" | "fold"
    bytes: int  # bytes this rank sends (0 for a fold or a wait)
    where: str  # the function that issued it
    phase: str = ""  # a permute's "post" or "wait"; "" otherwise
    ident: int = -1  # pairs a permute's post with its wait


_RECORD: Optional[List[Event]] = None
_NEXT_ID = [0]


@contextlib.contextmanager
def recording() -> Iterator[List[Event]]:
    """Record this process's collectives while the block runs; yields the
    list the events are appended to."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _caller(depth: int = 2) -> str:
    return sys._getframe(depth).f_code.co_name


def _note(kind: str, nbytes: int, where: str, phase: str = "", ident: int = -1) -> None:
    if _RECORD is not None:
        _RECORD.append(Event(kind, int(nbytes), where, phase, ident))


def note_fold() -> None:
    """Mark a ring fold in the record (its position between a shift's post
    and wait is what `utils.collectives.assert_overlappable` checks)."""
    if _RECORD is not None:
        _note("fold", 0, _caller())


# ---- groups and meshes -------------------------------------------------------------


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    return dist.get_rank(group)


def shard(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous shard of x along `dim` (the size must divide)."""
    n, w = x.shape[dim], axis_size(group)
    if n % w:
        raise ValueError(f"size {n} along dim {dim} is not divisible by the group size {w}")
    per = n // w
    return x.narrow(dim, axis_index(group) * per, per)


# ---- transport --------------------------------------------------------------------


def _host_for(group, t: torch.Tensor, op: str) -> bool:
    return t.is_cuda and op not in _GLOO_DEVICE_OPS and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """The tensor as it travels: contiguous, bool as uint8, on the host
    where gloo needs it."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.cpu() if host else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        t = t.view(torch.bool)
    return t.to(like.device)


def _leaves(tree) -> Tuple[List[torch.Tensor], Any]:
    flat, _ = pytree.flatten(tree)
    return [leaf for _, leaf in flat], tree


def psum(tree, group):
    """Every leaf of `tree` summed over `group`: one flat all_reduce(SUM) for
    each dtype among the leaves (one in practice: the step's statistics are
    float32). Returns the same structure."""
    leaves, like = _leaves(tree)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    where = _caller() if _RECORD is not None else ""
    for idx in by_dtype.values():
        parts = [leaves[i].reshape(-1) for i in idx]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        host = _host_for(group, flat, "all_reduce")
        buf = _wire(flat, host)
        _note("all-reduce", buf.numel() * buf.element_size(), where)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf = _unwire(buf, flat)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[off:off + n].reshape(leaves[i].shape)
            off += n
    return pytree.unflatten(like, out)


class Permute:
    """A posted `lax.ppermute` of a list of tensors over `group`: `perm`
    holds (source, destination) pairs of group ranks; `wait()` returns the
    received tensors (zeros where this rank receives nothing)."""

    def __init__(self, tensors: Sequence[torch.Tensor], group, perm: Sequence[Tuple[int, int]],
                 where: str = ""):
        self._like = [t.contiguous() for t in tensors]
        me = axis_index(group)
        dst = [d for s, d in perm if s == me and d != me]
        src = [s for s, d in perm if d == me and s != me]
        self._self = any(s == me and d == me for s, d in perm)
        self._sent: List[torch.Tensor] = []  # alive until the sends complete
        self._bufs: List[torch.Tensor] = []
        self._reqs = []
        self._ident = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        self._where = where
        if not dst and not src:
            return
        ops = []
        nbytes = 0
        for t in self._like:
            host = _host_for(group, t, "p2p")
            w = _wire(t, host)
            for d in dst:
                ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, d), group))
                nbytes += w.numel() * w.element_size()
            if src:
                buf = torch.empty_like(w)
                ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src[0]), group))
                self._bufs.append(buf)
            self._sent.append(w)
        _note("collective-permute", nbytes, self._where, "post", self._ident)
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        if self._reqs:
            _note("collective-permute", 0, self._where, "wait", self._ident)
        if self._self:  # a rank that sends to itself keeps its tensors
            return list(self._like)
        if self._bufs:
            return [_unwire(b, like) for b, like in zip(self._bufs, self._like)]
        return [torch.zeros_like(t) for t in self._like]


def permute(tensors: Sequence[torch.Tensor], group, perm: Sequence[Tuple[int, int]]):
    """`lax.ppermute` of a list of tensors, posted and waited at once."""
    return Permute(tensors, group, perm, _caller() if _RECORD is not None else "").wait()


def ring_shift(tensors: Sequence[torch.Tensor], group) -> Permute:
    """Post the ring's shift (send to rank - 1, receive from rank + 1);
    `.wait()` returns the next shard's tensors. At a group size of 1 it
    posts nothing and hands the tensors back."""
    n = axis_size(group)
    return Permute(tensors, group, [(j, (j - 1) % n) for j in range(n)],
                   _caller() if _RECORD is not None else "")


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(W, ...) -> (W, ...): chunk j goes to rank j, and row j of the
    result is what rank j sent this rank."""
    n = axis_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all needs a leading dim of {n}, got {tuple(x.shape)}")
    host = _host_for(group, x, "all_to_all")
    w = _wire(x, host)
    _note("all-to-all", w.numel() * w.element_size(), _caller() if _RECORD is not None else "")
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _unwire(out, x)


def all_gather(tree, group):
    """Every leaf concatenated along dim 0 over the group, in rank order:
    one all_gather of a flat buffer for each dtype among the leaves."""
    leaves, like = _leaves(tree)
    n = axis_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    where = _caller() if _RECORD is not None else ""
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        host = _host_for(group, flat, "all_gather")
        w = _wire(flat, host)
        _note("all-gather", w.numel() * w.element_size(), where)
        buf = torch.empty((n * w.numel(),), dtype=w.dtype, device=w.device)
        _ALL_GATHER(buf, w, group=group)
        buf = _unwire(buf, flat).reshape(n, -1)
        off = 0
        for i in idx:
            leaf = leaves[i]
            k = leaf.numel()
            out[i] = buf[:, off:off + k].reshape((n * leaf.shape[0],) + tuple(leaf.shape[1:]))
            off += k
    return pytree.unflatten(like, out)
