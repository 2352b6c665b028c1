"""The port's own spans in a traced window: the device time each holds
and the device's idle time inside it.

The port marks its host code with ``tdax.*`` ranges
(``tdax_torch.utils.log.span``: ``tdax.capture``, ``tdax.visual``,
``tdax.decoder``, ``tdax.train_step``, ``tdax.backward``, ``tdax.clip``
and the extract loop's) whenever a profiler records, on the clock of the
device trace.  ``ProgramSpans`` reads them from the profiler's
Chrome-trace events, over the same ``bench.window`` and the same device
operations as ``benchmark.trace.Trace``:

- a kernel belongs to the innermost ``tdax.*`` range that holds its
  launch, among the launching thread's ranges, or among every thread's
  where that thread has none (autograd's device thread launches the
  backward inside the main thread's ``tdax.backward``);
- ``kernel_s(name)``: summed time of the kernels that belong to a range
  named ``name``;
- ``idle_s(name)``: the time inside the union of the ``name`` ranges,
  clipped to the window, with no operation on the device.

``readings(units)`` gives, per unit, what those say of the port's
layers: ``visual_ms``, ``decoder_ms``, ``backward_ms``, ``clip_ms`` and
``program_idle_ms`` (the idle time inside ``tdax.capture`` or
``tdax.train_step``: the card waiting on the port's own host code, apart
from the job's copies), each None where the window holds nothing for it.

    python3 -m benchmark.program_spans --workload <cell> --seed <n>

runs a cell's traced units on the card as ``benchmark.run --trace 1``
does (no check) and prints one JSON line: those readings, every span's
kernel and idle time per unit, the kernel time under no span, the busy
and window time per unit, and the cell's per-layer metrics and idle gaps
read from the same trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import run, spec
from benchmark.jobs import Spans
from benchmark.trace import DEVICE_CATS, WINDOW, Trace

PREFIX = "tdax."
# per-unit readings: (name, the span whose kernels it sums)
KERNEL_READINGS = (("visual_ms", "visual"), ("decoder_ms", "decoder"),
                   ("backward_ms", "backward"), ("clip_ms", "clip"))
# the span whose idle time ``program_idle_ms`` reads, the first the trace holds
UNIT_SPANS = ("capture", "train_step")


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class ProgramSpans:
    def __init__(self, events: list[dict]):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X" and e["name"] == WINDOW]
        if not window:
            raise ValueError("the trace holds no bench.window range")
        self.start = window[0]["ts"] * 1e-6
        self.end = (window[0]["ts"] + window[0].get("dur", 0)) * 1e-6
        # (start, end, name without the prefix, thread)
        self.ranges = [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6,
                        e["name"][len(PREFIX):], e.get("tid"))
                       for e in events if e.get("cat") == "user_annotation"
                       and e.get("ph") == "X" and e["name"].startswith(PREFIX)]
        launch = {e["args"]["correlation"]: (e["ts"] * 1e-6, e.get("tid")) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        threads = {r[3] for r in self.ranges}
        # (start, end, kernel, the span it belongs to or None)
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = max(e["ts"] * 1e-6, self.start)
            b = min((e["ts"] + e.get("dur", 0)) * 1e-6, self.end)
            if b <= a:
                continue
            at = launch.get(e.get("args", {}).get("correlation"))
            owner = None if at is None else self._owner(at[0], at[1] if at[1] in threads
                                                       else None)
            self.ops.append((a, b, e["cat"] == "kernel", owner))

    def _owner(self, t: float, tid) -> str | None:
        """The innermost range holding ``t``, of thread ``tid`` (every
        thread's where None)."""
        inner = [(b - a, name) for a, b, name, th in self.ranges
                 if a <= t <= b and (tid is None or th == tid)]
        return min(inner)[1] if inner else None

    def names(self) -> list[str]:
        return sorted({r[2] for r in self.ranges})

    def kernel_s(self, name: str | None) -> float:
        """Time of the kernels that belong to a ``name`` range (to none
        where ``name`` is None)."""
        return sum(b - a for a, b, kernel, owner in self.ops if kernel and owner == name)

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union((a, b) for a, b, _, _ in self.ops))

    def idle_s(self, name: str) -> float:
        """Device-idle time inside the union of the ``name`` ranges."""
        spans = _union((max(a, self.start), min(b, self.end)) for a, b, n, _ in self.ranges
                       if n == name and min(b, self.end) > max(a, self.start))
        busy = _union((a, b) for a, b, _, _ in self.ops)
        idle = 0.0
        for a, b in spans:
            covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
            idle += (b - a) - covered
        return idle

    def readings(self, units: int) -> dict:
        """Per unit, in ms: the four spans' kernel time and the idle time
        inside the unit's span; None where the window holds nothing."""
        out: dict = {}
        for metric, name in KERNEL_READINGS:
            s = self.kernel_s(name)
            out[metric] = 1e3 * s / units if units > 0 and s > 0 else None
        held = set(self.names())
        unit_span = next((n for n in UNIT_SPANS if n in held), None)
        on_device = units > 0 and self.busy_s() > 0
        out["program_idle_ms"] = (1e3 * self.idle_s(unit_span) / units
                                  if unit_span is not None and on_device else None)
        return out


def traced_events(job, n_units: int) -> tuple[list, object]:
    """The Chrome-trace events of ``n_units`` units under torch.profiler,
    as ``benchmark.run.traced`` records them, and the harness's ``Trace``
    of the same events."""
    activities = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        job.unit(0)
        job.drain()
        with record_function(WINDOW):
            for i in range(n_units):
                job.unit(i + 1)
            job.drain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return events, Trace(events)


def report(cell, seed: int, device: str) -> dict:
    """One traced window of ``cell``: the spans' readings beside the
    cell's per-layer metrics, from one trace."""
    job = spec.job(cell.job)(cell, seed, device, Spans(on=True))
    job.setup()
    job.drain()
    units = cell.traffic["trace_units"]
    events, tr = traced_events(job, units)
    ps = ProgramSpans(events)
    ctx = types.SimpleNamespace(trace=tr, work=job.work, units=units)
    on_card = job.device.type == "cuda"
    job.release()
    return {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu", "units": units,
        "program_spans": ps.readings(units),
        "kernel_ms_by_span": {n: 1e3 * ps.kernel_s(n) / units for n in ps.names()},
        "kernel_ms_outside_spans": 1e3 * ps.kernel_s(None) / units,
        "idle_ms_by_span": {n: 1e3 * ps.idle_s(n) / units for n in ps.names()},
        "busy_ms": 1e3 * tr.busy_s() / units, "window_ms": 1e3 * tr.window_s / units,
        "per_layer": {m["name"]: spec.layer_reader(m["name"]).read(ctx) for m in cell.per_layer},
        "idle_gaps": tr.idle_gaps(10),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.fix_caches()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"program_spans: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    print(json.dumps(report(cell, args.seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
