"""A cell end to end on the CPU at a tiny size: the explicit rehearsal
path of ``benchmark.run`` for tests and for trying a change without the
card.  The measurement path itself (``python3 -m benchmark.run``) refuses
to run without a card.

The cell's configuration is replaced by the tiny sizes its job declares
(``Job.tiny(cfg, dtype)``), its mix by the mix file's ``rehearse``
overrides, and the timed window by a fixed number of units, so that a
loaded CPU runs the same work as an idle one; everything else is the
cell's own path: the job, the port on CPU tensors (the kernels' plain
versions), the window, the trace readers and the check against the
reference with the cell's limits.  A number it prints is a CPU number
and names no device.
"""

from __future__ import annotations

import time

from benchmark import spec
from benchmark.run import run_cell


def tiny_cell(workload: str, dtype: str = "float32", root=spec.ROOT) -> spec.Cell:
    cell = spec.cell(workload, root=root)
    cell.config = spec.job(cell.job).tiny(cell.config, dtype)
    cell.traffic = {**cell.traffic, **cell.traffic.get("rehearse", {})}
    return cell


def rehearse(workload: str, seed: int = 0, units: int = 2, trace: bool = False,
             dtype: str = "float32", root=spec.ROOT) -> dict:
    """One run of ``workload`` at the tiny size: ``units`` units timed
    (a traced run traces the mix's ``trace_units``)."""
    return run_cell(tiny_cell(workload, dtype, root), seed, 0.0, trace, "cpu",
                    t_start=time.perf_counter(), units=units)
