"""Profiling helpers: spans and fetches on `torch.profiler`'s clock, one
launch counter for the hand-written kernels, wall timers fenced on the
device, and `torch.profiler` traces.

Mirrors `icpx/utils/profiling.py`, and adds what the port's host loop
needs measured:

  * `span(name)`: a `record_function` range while a profiler records, and
    one shared no-op context otherwise (a flag read; nothing allocated).
    The ranges land in the profiler's chrome trace as "user_annotation"
    events beside the device's kernels, nested by time. Every name starts
    with `icpx.`; PERF.md lists them and the metrics that read them.
  * `fetch(t)` / `fetch_int(t)`: `bool(t)` / `int(t)` inside an
    `icpx.fetch` span. The ICP loop, the normals and covariances and the
    compiled odometry read the device only through them, so a trace counts
    and times those syncs.
  * `LAUNCHES`: launches of each hand-written kernel, keyed by kernel
    (each launch site adds one to its key).
  * `nn_counters(device)`: how often the nn kernel's paths for rows that
    carry nothing for its screen engage, summed over its calls on a
    device: far query rows and empty reference tiles skipped. The kernel
    adds to one persistent int64 tensor a device (`nn_counter_tensor`) in
    atomics it runs anyway, so counting costs no launch and no read;
    `nn_counters` reads it (a sync: keep it off timed paths).

`HBM_BYTES_PER_S` and `FP32_FLOPS` are one H100 SXM's (NVIDIA's data
sheet, at its 700 W power limit; a card capped lower runs slower under
load, so quote the card's name and limit beside every time).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from icpx_torch.utils import pytree

# One H100 SXM at 700 W: HBM3 bytes a second, and fp32 operations a second
# on the CUDA cores (no tensor cores; an FMA counts 2).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

LAUNCHES = {"nn": 0, "moments6": 0, "fold6": 0, "fold7": 0, "select": 0, "fused4": 0,
            "moments_fused": 0, "sort": 0}

NN_COUNTERS = ("far_rows", "empty_tiles")  # the nn kernel's counters, in its order
_NN_COUNTS = {}  # device index -> int64 (len(NN_COUNTERS),) on that device

_OFF = contextlib.nullcontext()  # what `span` returns while no profiler records


def span(name: str):
    """A context naming the scope `name` in a running profiler's trace;
    with no profiler recording, a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def fetch(t) -> bool:
    """`bool(t)`, a device-to-host read, inside an `icpx.fetch` span."""
    if not _autograd_profiler._is_profiler_enabled:
        return bool(t)
    with torch.profiler.record_function("icpx.fetch"):
        return bool(t)


def fetch_int(t) -> int:
    """`int(t)`, a device-to-host read, inside an `icpx.fetch` span."""
    if not _autograd_profiler._is_profiler_enabled:
        return int(t)
    with torch.profiler.record_function("icpx.fetch"):
        return int(t)


def nn_counter_tensor(device) -> torch.Tensor:
    """The nn kernel's counters on CUDA `device`, made (zero) at first use:
    the tensor the kernel adds its far rows and skipped empty tiles to.
    A first use inside a CUDA graph capture is refused: the zero fill
    would be a node of the graph, run again at every replay."""
    index = torch.device(device).index or 0
    if index not in _NN_COUNTS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the nn kernel's counters on cuda:{index} are made at its first "
                               "call, which must come before any CUDA graph capture")
        _NN_COUNTS[index] = torch.zeros(len(NN_COUNTERS), dtype=torch.int64,
                                        device=torch.device("cuda", index))
    return _NN_COUNTS[index]


def nn_counters(device="cuda") -> dict:
    """The nn kernel's counters on `device`, summed over its calls there
    (zeros before the first): {"far_rows": n, "empty_tiles": n}."""
    index = torch.device(device).index or 0
    counts = _NN_COUNTS[index].tolist() if index in _NN_COUNTS else [0] * len(NN_COUNTERS)
    return dict(zip(NN_COUNTERS, counts))


def _fence(out) -> None:
    """Wait for the device work behind every tensor of `out`.

    The reference fetches one scalar from every leaf: on its relayed TPU
    backend `block_until_ready` could return before the work finished.
    `torch.cuda.synchronize` on the output's device is a real fence."""
    leaves, _ = pytree.flatten(out)
    for dev in {leaf.device for _, leaf in leaves if torch.is_tensor(leaf) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer: ``with Timer() as t: out = t.block(f(x))``, then
    `t.elapsed` seconds (pass the outputs through `block` so the device
    work is inside the interval)."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0

    def block(self, out):
        _fence(out)
        return out


def time_fn(fn, *args, reps: int = 5, warmup: int = 1, cache_bust=None) -> float:
    """Median wall seconds of fn(*args), each rep fenced on the device.

    `cache_bust`: optional callable (rep index) -> an extra argument
    appended each rep, for backends that memoize identical executions (the
    reference's TPU relay did; a CUDA device does not)."""
    for _ in range(warmup):
        _fence(fn(*args, *([cache_bust(0)] if cache_bust else [])))
    times = []
    for r in range(reps):
        extra = [cache_bust(r + 1)] if cache_bust else []
        t0 = time.perf_counter()
        _fence(fn(*args, *extra))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def trace_context(log_dir: str):
    """A `torch.profiler` trace of the scope (CPU, and CUDA when a device is
    present), written to `log_dir` for TensorBoard or Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))
    ):
        yield

