"""Reduction of a torch.profiler trace of a stretch of the window.

The stretch is the span of the "bench.request" annotations the harness puts
around each profiled request. Device activity is every kernel, copy and
memset on the card; its union over the stretch is the busy time. An idle
gap is a stretch between two busy intervals, named by the innermost host
operation that spans its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
MARK = "bench.request"


class Trace:
    def __init__(self, events: List[dict]):
        dev, host, marks = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            name, cat = str(e.get("name", "")), str(e.get("cat", ""))
            if name == MARK:
                marks.append((ts, ts + dur))
            elif cat in DEVICE_CATS:
                dev.append((ts, ts + dur, name))
            elif cat in HOST_CATS:
                host.append((ts, ts + dur, name))
        self.start = min((a for a, _ in marks), default=0.0)
        self.end = max((b for _, b in marks), default=0.0)
        self.device = sorted((a, b, n) for a, b, n in dev if b > self.start and a < self.end)
        self.host = host

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data.get("traceEvents", data) if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return max(self.end - self.start, 0.0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b, _ in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name contains one of `names`."""
        names = tuple(names)
        return sum(b - a for a, b, n in self.device if any(k in n for k in names)) * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            total[n] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            over = [h for h in self.host if h[0] <= mid <= h[1] and h[2] != MARK]
            name = min(over, key=lambda h: h[1] - h[0])[2] if over else "no host operation"
            out.append([name, (b - a) * 1e-6])
        return out
