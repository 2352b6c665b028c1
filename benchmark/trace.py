"""The traced window, read from torch.profiler's trace.

``Trace`` takes the profiler's Chrome-trace events and the window (the
benchmark's ``bench.window`` range on the host).  Device operations are
the trace's kernels, copies and fills; each is tied to the host call
that launched it through the trace's correlation ids (the launch's time
and thread), so a kernel launched inside torch.optim's
``Optimizer.step`` range is known as the optimizer's.  All times are
seconds.

- ``busy_s``: the union of device operations' intervals inside the window;
- ``kernel_s(names)``: summed time of kernels whose name contains one of
  ``names``;
- ``top_ops(n)``: the device operations that took most time, by name;
- ``idle_gaps(n)``: the longest stretches inside the window with nothing
  on the device, each named by the innermost benchmark span (``bench.*``)
  the host was in at the gap's middle.

The port marks its host code with ``tdax.*`` ranges
(``tdax_torch.utils.log.span``) whenever a profiler records.  ``Trace``
keeps them, with their threads, and gives each operation the span it
belongs to: the innermost ``tdax.*`` range that holds its launch, among
the launching thread's ranges, or among every thread's where that thread
has none (autograd's device thread launches the backward inside the main
thread's ``tdax.backward``).  Per-layer readers read them by name, the
prefix left out:

- ``span_kernel_s(name)``: summed time of the kernels that belong to a
  ``name`` range (to none where ``name`` is None);
- ``span_idle_s(name)``: the time inside the union of the ``name``
  ranges, clipped to the window, with no operation on the device;
- ``span_count(name)``: the ``name`` ranges the window holds (a counter
  a span can carry).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
PROGRAM = "tdax."


@dataclasses.dataclass
class Op:
    name: str
    start: float
    end: float
    kernel: bool
    optimizer: bool
    launch_at: float | None = None  # the launching host call's start
    launch_tid: object = None       # and its thread
    span: str | None = None         # the ``tdax.*`` span it belongs to, prefix left out


@dataclasses.dataclass
class Range:
    start: float
    end: float
    name: str
    tid: object


def _cpu_ranges(events, pred) -> list[tuple[float, float, str]]:
    return [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X" and pred(e["name"])]


def _within(t: float, ranges) -> bool:
    return any(a <= t <= b for a, b, _ in ranges)


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    def __init__(self, events: list[dict]):
        windows = _cpu_ranges(events, lambda n: n == WINDOW)
        if not windows:
            raise ValueError("the trace holds no bench.window range")
        self.start, self.end = windows[0][0], windows[0][1]
        self.spans = _cpu_ranges(events, lambda n: n.startswith("bench.") and n != WINDOW)
        self.program = [Range(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6,
                              e["name"][len(PROGRAM):], e.get("tid"))
                        for e in events if e.get("cat") == "user_annotation"
                        and e.get("ph") == "X" and e["name"].startswith(PROGRAM)]
        threads = {r.tid for r in self.program}
        opt = _cpu_ranges(events, lambda n: n.startswith("Optimizer.step"))
        launch = {e["args"]["correlation"]: (e["ts"] * 1e-6, e.get("tid")) for e in events
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
            t, tid = launch.get(e.get("args", {}).get("correlation"), (None, None))
            span = None if t is None else self._owner(t, tid if tid in threads else None)
            self.ops.append(Op(e["name"], a, b, e["cat"] == "kernel",
                               t is not None and _within(t, opt), t, tid, span))
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
        return _union((op.start, op.end) for op in self.ops)

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

    # --- the port's spans ----------------------------------------------
    def _owner(self, t: float, tid) -> str | None:
        """The innermost ``tdax.*`` range holding ``t``, of thread ``tid``
        (every thread's where None)."""
        inner = [(r.end - r.start, r.name) for r in self.program
                 if r.start <= t <= r.end and (tid is None or r.tid == tid)]
        return min(inner)[1] if inner else None

    def span_names(self) -> list[str]:
        return sorted({r.name for r in self.program})

    def span_kernel_s(self, name: str | None) -> float:
        """Time of the kernels that belong to a ``name`` range (to none
        where ``name`` is None)."""
        return sum(op.end - op.start for op in self.ops if op.kernel and op.span == name)

    def span_idle_s(self, name: str) -> float:
        """Device-idle time inside the union of the ``name`` ranges,
        clipped to the window."""
        spans = _union((max(r.start, self.start), min(r.end, self.end)) for r in self.program
                       if r.name == name and min(r.end, self.end) > max(r.start, self.start))
        busy = self._busy()
        idle = 0.0
        for a, b in spans:
            covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
            idle += (b - a) - covered
        return idle

    def span_count(self, name: str) -> int:
        """The ``name`` ranges that lie inside the window."""
        return sum(1 for r in self.program
                   if r.name == name and self.start <= r.start and r.end <= self.end)
