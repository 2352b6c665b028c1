"""The port's own spans in a traced window, span by span.

The port marks its host code with ``tdax.*`` ranges
(``tdax_torch.utils.log.span``: ``tdax.capture``, ``tdax.visual``,
``tdax.decoder``, ``tdax.train_step``, ``tdax.backward``, ``tdax.clip``
and the extract loop's) whenever a profiler records, on the clock of the
device trace.  ``benchmark.trace.Trace`` gives each kernel the span it
belongs to; the per-layer metrics ``visual_ms``, ``decoder_ms``,
``backward_ms``, ``clip_ms`` and ``program_idle_ms`` read them.

    python3 -m benchmark.program_spans --workload <cell> --seed <n>

runs a cell's traced units on the card as ``benchmark.run --trace 1``
does (no check) and prints one JSON line: the five span metrics, every
span's kernel and idle time and range count per unit, the kernel time
under no span, the busy and window time per unit, and the cell's
per-layer metrics and idle gaps read from the same trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import torch

from benchmark import run, spec
from benchmark.jobs import Spans

# the per-layer metrics that read the port's spans
READINGS = ("visual_ms", "decoder_ms", "backward_ms", "clip_ms", "program_idle_ms")


def report(cell, seed: int, device: str) -> dict:
    """One traced window of ``cell``: the spans' readings beside the
    cell's per-layer metrics, from one trace."""
    job = spec.job(cell.job)(cell, seed, device, Spans(on=True))
    job.setup()
    job.drain()
    units = cell.traffic["trace_units"]
    tr, _ = run.traced(job, units)
    ctx = types.SimpleNamespace(trace=tr, work=job.work, units=units)
    on_card = job.device.type == "cuda"
    job.release()
    names = tr.span_names()
    return {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu", "units": units,
        "program_spans": {m: spec.layer_reader(m).read(ctx) for m in READINGS},
        "kernel_ms_by_span": {n: 1e3 * tr.span_kernel_s(n) / units for n in names},
        "kernel_ms_outside_spans": 1e3 * tr.span_kernel_s(None) / units,
        "idle_ms_by_span": {n: 1e3 * tr.span_idle_s(n) / units for n in names},
        "ranges_by_span": {n: tr.span_count(n) for n in names},
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
