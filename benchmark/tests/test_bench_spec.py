"""BENCHMARK.json in the shape the harness relies on, and every
cell, configuration, mix, limits file and per-layer metric found by name;
a new mix is a new file and a new entry."""

import json
import re
import shutil

import pytest

from benchmark import spec
from benchmark.rehearse import rehearse

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[section]
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if "why" in e:
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_metrics_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _holds(cfg: dict, key: str) -> bool:
    """The file holds ``key``: a top-level key, or a dotted path into a
    nested group."""
    node = cfg
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return False
        node = node[part]
    return True


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    cell = spec.cell(name)
    entry = next(c for c in SPEC["configs"] if c["name"] == cell.config_name)
    cfg = cell.config
    assert cell.chips == 1
    assert cfg["name"] == cell.config_name
    assert cfg["reduced"] == entry["reduced"]
    for key in cfg["reduced"] + cfg["assumed"]:
        assert _holds(cfg, key), f"{key!r} is not in {entry['file']}"
    if cfg["reduced"]:
        assert all(_holds(cfg["published"], key) for key in cfg["reduced"]), cfg["published"]
        assert cfg["deployment"]
    assert spec.job(cell.job).unit_name in ("sample", "sequence")
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert {"samples_per_s", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert set(cell.limits["limits"]) and cell.limits["control"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(spec.layer_reader(metric).read)


def test_new_mix_is_a_file_and_an_entry(tmp_path):
    """A cell is added as a mix file, a limits file and an entry: the
    harness runs it with no existing file edited."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((tmp_path / "benchmark/traffic/capture.json").read_text())
    mix["batch_size"] = 8
    (tmp_path / "benchmark/traffic/capture-b8.json").write_text(json.dumps(mix))
    limits = json.loads((tmp_path / "benchmark/limits/qwen-vl-chat.capture.json").read_text())
    (tmp_path / "benchmark/limits/qwen-vl-chat.capture-b8.json").write_text(json.dumps(limits))
    bench = json.loads(json.dumps(SPEC))
    bench["workloads"].append({"name": "qwen-vl-chat.capture-b8", "config": "qwen-vl-chat",
                               "traffic": "capture-b8", "chips": 1, "why": "batch 8"})
    for m in bench["per_layer"]:
        if "qwen-vl-chat.capture" in m["workloads"]:
            m["workloads"].append("qwen-vl-chat.capture-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("qwen-vl-chat.capture-b8", root=tmp_path)
    assert cell.traffic["batch_size"] == 8
    result = rehearse("qwen-vl-chat.capture-b8", seed=5, root=tmp_path)
    assert result["correct"] and result["attempted"] % 8 == 0
