"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is one configuration under one
traffic mix.  Its files:

- ``benchmark/configs/<config>.json``: the configuration's sizes and
  numerics (the file ``BENCHMARK.json`` names for it);
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the
  job the mix names (``benchmark/jobs/<job>.py``, which also declares the
  job's faults, its tiny rehearsal sizes and the spans its units hold);
- ``benchmark/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``benchmark/layer_metrics/<metric>.py``: one reader per per-layer
  metric.

A later cell, mix, configuration or metric is a new file and a new entry;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def job(self) -> str:
        return self.traffic["job"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell named ``name`` with its files read."""
    spec = spec if spec is not None else load(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if m["moves"] in reported and _applies(m, name)]
    bench = root / "benchmark"
    return Cell(name=name, chips=entry["chips"], config_name=entry["config"],
                config=_read_json(root / config["file"]),
                traffic_name=entry["traffic"],
                traffic=_read_json(bench / "traffic" / f"{entry['traffic']}.json"),
                limits=_read_json(bench / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def layer_reader(metric: str):
    """The module that reads the per-layer metric ``metric``."""
    return importlib.import_module(f"benchmark.layer_metrics.{metric}")


def job(name: str):
    """The job class a traffic mix names."""
    return importlib.import_module(f"benchmark.jobs.{name}").Job
