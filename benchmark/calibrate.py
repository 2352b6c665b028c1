"""The readings a cell's limits are set from, at the cell's own size, on
the card, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each of ``--seeds``: the cell's set-up, ``--units`` units of its
window, then the job's check against the f32 reference; that is a
sound run of the program, and the largest reading over the seeds is a
number's lower reading.  For each of ``--control-seeds``: the same
set-up and units, then the control in the program's place (the
reference in the lower precision the cell's limits file names) held to
the reference; the smallest reading is a number's upper reading.  One
JSON line per seed and kind, then the summary.  ``--fault <kind>``
plants one of ``benchmark.faults`` under the timed path for the
``--seeds`` runs instead: its readings are a training number's upper
reading where they read ten times its lower one or more.  The limits are set in
``benchmark/limits/<cell>.json`` from these readings, never here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from benchmark import faults, spec
from benchmark.jobs import Spans
from benchmark.run import fix_caches


def readings(cell, seed: int, units: int, control: bool, fault: str | None = None) -> dict:
    job = spec.job(cell.job)(cell, seed, "cuda", Spans())
    with faults.planted(cell.job, fault) if fault else contextlib.nullcontext():
        job.setup()
        for i in range(units):
            job.unit(i)
        job.drain()
    job.release()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = job.control() if control else job.check()
    kind = "control" if control else fault or "program"
    return {"seed": seed, "kind": kind, **numbers,
            "reference_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    fix_caches()
    cell = spec.cell(args.workload)
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            row = readings(cell, seed, args.units, control, None if control else args.fault)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for name in cell.limits["limits"]:
        summary[name] = {}
        for kind in sorted({r["kind"] for r in rows}):
            vals = [r[name] for r in rows if r["kind"] == kind]
            summary[name][kind] = {"least": min(vals), "largest": max(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
