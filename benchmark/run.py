"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  Set-up (imports, the card, the kernels' builds or their
cache, the weights and inputs from the seed, every shape warmed up) is
``setup_s``.  Then the window: with ``--trace 0`` units of work run until
``--seconds`` have passed and the card has finished them, timed by the
host clock (``end_to_end`` metrics); with ``--trace 1`` the mix's
``trace_units`` run under torch.profiler and the per-layer readers read
the trace.  Once the window has closed and the peak memory is read, the
program's state is freed and the job's check holds what the window
produced against the f32 reference.  The last line of standard output is
the result; the numbers compared, each with its limit, are the last
lines of standard error and the result's last key.

The run refuses (exit 2, no result) without the card(s), and fails
(exit 3, no result) if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tdax")


def fix_caches() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.jobs import Spans  # noqa: E402
from benchmark.trace import WINDOW, Trace  # noqa: E402


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(job, seconds: float) -> tuple[int, float]:
    """(samples, seconds) of the window: units until ``seconds`` have
    passed, then the card drained."""
    job.drain()
    t0 = time.perf_counter()
    units = samples = 0
    while True:
        samples += job.unit(units)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    job.drain()
    return samples, time.perf_counter() - t0


def measure_units(job, units: int) -> tuple[int, float]:
    """(samples, seconds) of exactly ``units`` units, then the device
    drained: the rehearsals' window."""
    job.drain()
    t0 = time.perf_counter()
    samples = sum(job.unit(i) for i in range(units))
    job.drain()
    return samples, time.perf_counter() - t0


def traced(job, n_units: int):
    """The mix's traced units under torch.profiler (one unit first,
    outside the window, for the profiler's own start)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        job.unit(0)
        job.drain()
        with record_function(WINDOW):
            samples = sum(job.unit(i + 1) for i in range(n_units))
            job.drain()
    return Trace.from_profiler(prof), samples


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float | None = None, units: int | None = None) -> dict:
    """One run of ``cell``; returns the result line's object.  The window
    lasts ``seconds``, or exactly ``units`` units where that is given."""
    t_start = T0 if t_start is None else t_start
    job = spec.job(cell.job)(cell, seed, device, Spans(on=trace))
    job.setup()
    job.drain()
    on_card = job.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    result: dict = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 0}
    if trace:
        tr, samples = traced(job, cell.traffic["trace_units"])
        ctx = types.SimpleNamespace(trace=tr, work=job.work,
                                    units=cell.traffic["trace_units"])
        for m in cell.per_layer:
            value = spec.layer_reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    elif units is None:
        samples, window_s = measure(job, seconds)
    else:
        samples, window_s = measure_units(job, units)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    result["attempted"] = samples
    if not trace:
        values = {"samples_per_s": samples / window_s, "peak_mem_gib": window_peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info["memory_peak_bytes"] = max(setup_peak, window_peak)
    result["device"] = device_info
    job.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = job.check()
    result["check_s"] = time.perf_counter() - t_check
    limits = cell.limits["limits"]
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    result["readings"] = {k: v for k, v in numbers.items() if k not in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = ok
    result["failed"] = 0 if ok else samples
    result["checks"] = checks  # last: the numbers compared, each with its limit
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, value in result.pop("readings").items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
