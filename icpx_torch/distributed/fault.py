"""Degraded-mode guard for the ICP loop, the stall watchdog and the fault
injectors.

Mirrors `degenerate_solve_guard`, `HeartbeatMonitor`,
`CollectiveStallError`, `guarded_call`, `default_stall_timeout`,
`drop_shard` and `corrupt_points` of `icpx/distributed/fault.py`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from icpx_torch.geometry.se3 import SE3


def degenerate_solve_guard(transform: SE3, stats, prev_transform: SE3):
    """Reject a solve update whose convergence stats are non-finite or whose
    inlier count collapsed: keep the previous transform instead.

    Returns (transform, ok) with `ok` a 0-d bool tensor; a select, so no
    host sync."""
    ok = (
        torch.isfinite(stats.rmse)
        & torch.isfinite(stats.diff)
        & (stats.inlier_count >= 3.0)
        & torch.isfinite(transform.t).all()
        & torch.isfinite(transform.R).all()
    )
    return SE3(
        R=torch.where(ok, transform.R, prev_transform.R),
        t=torch.where(ok, transform.t, prev_transform.t),
    ), ok


def _fence(out) -> None:
    """Wait for the device work behind `out` (a tensor or a tuple of them)."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if torch.is_tensor(x) and x.is_cuda:
            torch.cuda.synchronize(x.device)


class HeartbeatMonitor:
    """Watchdog for device stalls: wrap each step's fence in `beat()`; a
    background thread sets `stalled` and calls `on_stall` (once a stall
    episode) when no beat lands within `timeout_s`."""

    def __init__(self, timeout_s: float = 300.0, on_stall: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.stalled = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatMonitor":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def beat(self, out=None):
        if out is not None:
            _fence(out)
        self._last = time.monotonic()
        self.stalled = False  # a successful beat clears a past stall
        return out

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def _watch(self):
        fired = False
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self.stalled = True
                if self.on_stall and not fired:
                    self.on_stall()
                    fired = True  # once a stall episode
            elif fired and not self.stalled:
                fired = False  # beats resumed: re-arm

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CollectiveStallError(RuntimeError):
    """A device fence (collective, transfer, scalar fetch) did not complete
    within the watchdog's timeout."""


def guarded_call(fn: Callable, timeout_s: float, on_stall: Optional[Callable] = None):
    """Run `fn` (a device fence: a scalar fetch, `.item()`, or
    `torch.cuda.synchronize()`) under a `HeartbeatMonitor`; raise
    `CollectiveStallError` if it does not return within `timeout_s`.

    The fence runs in a worker thread, since a stalled fence blocks inside
    the runtime's C call where the main thread cannot be interrupted.
    `timeout_s <= 0` runs `fn` inline (watchdog off)."""
    if timeout_s <= 0:
        return fn()
    box: dict = {}

    def work():
        try:
            box["value"] = fn()
        except BaseException as e:  # raised in the caller below
            box["error"] = e

    with HeartbeatMonitor(timeout_s=timeout_s, on_stall=on_stall) as mon:
        t = threading.Thread(target=work, daemon=True)
        t.start()
        while t.is_alive() and not mon.stalled:
            t.join(min(timeout_s / 20, 1.0))
        if t.is_alive():
            raise CollectiveStallError(
                f"device fence did not complete within {timeout_s:.0f}s: a hung "
                "device or transport; checkpoint-and-restart is the recovery path"
            )
        mon.beat()
    if "error" in box:
        raise box["error"]
    return box["value"]


def default_stall_timeout(device=None, warmup: bool = False) -> float:
    """The watchdog's default for the data's device: off on the CPU (no
    transport to stall), on for CUDA (1200 s while warming up, else 600 s).
    `device` None means the first CUDA device, the port's default."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return 0.0
    return 1200.0 if warmup else 600.0


# ---- fault injection (tests) -------------------------------------------------


def drop_shard(mask: torch.Tensor, shard_index: int, n_shards: int) -> torch.Tensor:
    """Simulate a host losing its data shard: clear the validity mask of
    one contiguous 1/n_shards slice."""
    n = mask.shape[0]
    s = n // n_shards
    idx = torch.arange(n, device=mask.device)
    dead = (idx >= shard_index * s) & (idx < (shard_index + 1) * s)
    return mask & ~dead


def corrupt_points(xyz: torch.Tensor, generator: Optional[torch.Generator] = None,
                   fraction: float = 0.05, magnitude: float = 100.0) -> torch.Tensor:
    """Inject gross outliers: each row is hit with probability `fraction`
    and moved by `magnitude` x a standard normal 3-vector. `generator`
    (on xyz's device) seeds the draws; it stands in for the reference's
    JAX key, so the rows hit are not the reference's."""
    hit = torch.rand(xyz.shape[0], generator=generator, device=xyz.device) < fraction
    noise = magnitude * torch.randn(xyz.shape, generator=generator, device=xyz.device,
                                    dtype=xyz.dtype)
    return torch.where(hit[:, None], xyz + noise, xyz)
