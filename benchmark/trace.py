"""The traced window, read from torch.profiler's trace.

``Trace`` takes the profiler's Chrome-trace events and the window (the
benchmark's ``bench.window`` range on the host).  Device operations are
the trace's kernels, copies and fills; each kernel is tied to the host
call that launched it through the trace's correlation ids, so a kernel
launched inside torch.optim's ``Optimizer.step`` range is known as the
optimizer's.  All times are seconds.

- ``busy_s``: the union of device operations' intervals inside the window;
- ``kernel_s(names)``: summed time of kernels whose name contains one of
  ``names``;
- ``top_ops(n)``: the device operations that took most time, by name;
- ``idle_gaps(n)``: the longest stretches inside the window with nothing
  on the device, each named by the innermost benchmark span (``bench.*``)
  the host was in at the gap's middle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclasses.dataclass
class Op:
    name: str
    start: float
    end: float
    kernel: bool
    optimizer: bool


def _cpu_ranges(events, pred) -> list[tuple[float, float, str]]:
    return [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X" and pred(e["name"])]


def _within(t: float, ranges) -> bool:
    return any(a <= t <= b for a, b, _ in ranges)


class Trace:
    def __init__(self, events: list[dict]):
        windows = _cpu_ranges(events, lambda n: n == WINDOW)
        if not windows:
            raise ValueError("the trace holds no bench.window range")
        self.start, self.end = windows[0][0], windows[0][1]
        self.spans = _cpu_ranges(events, lambda n: n.startswith("bench.") and n != WINDOW)
        opt = _cpu_ranges(events, lambda n: n.startswith("Optimizer.step"))
        launch = {e["args"]["correlation"]: e["ts"] * 1e-6 for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = max(e["ts"] * 1e-6, self.start)
            b = min((e["ts"] + e.get("dur", 0)) * 1e-6, self.end)
            if b <= a:
                continue
            t = launch.get(e.get("args", {}).get("correlation"))
            self.ops.append(Op(e["name"], a, b, e["cat"] == "kernel",
                               t is not None and _within(t, opt)))
        self.ops.sort(key=lambda op: op.start)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def _busy(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for op in self.ops:
            if merged and op.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op.end)
            else:
                merged.append([op.start, op.end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy())

    def kernel_s(self, names, optimizer=None, exclude=()) -> float:
        """Time of the kernels whose name holds one of ``names`` (every
        kernel when ``names`` is None) and none of ``exclude``; with
        ``optimizer`` True or False, only those inside or outside
        ``Optimizer.step``."""
        total = 0.0
        for op in self.ops:
            if not op.kernel or (optimizer is not None and op.optimizer != optimizer):
                continue
            name = op.name.lower()
            if names is not None and not any(n in name for n in names):
                continue
            if any(n in name for n in exclude):
                continue
            total += op.end - op.start
        return total

    def top_ops(self, n: int = 10) -> list:
        by_name: dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start)
        return [[name[:120], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def _span_at(self, t: float) -> str:
        inner = [(b - a, name) for a, b, name in self.spans if a <= t <= b]
        return min(inner)[1][len("bench."):] if inner else "host"

    def idle_gaps(self, n: int = 10) -> list:
        busy = self._busy()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[k + 1] - edges[k], edges[k]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        gaps.sort(reverse=True)
        return [[self._span_at(start + length / 2), length] for length, start in gaps[:n]]
