"""A configuration of another kind of model is added as new files and new
``BENCHMARK.json`` entries only.

The test copies ``benchmark/`` and ``BENCHMARK.json``, adds a stand-in
job under a new name (its own tiny sizes, faults and spans, its entry
point taking the batch in other argument places), its configuration with
a key under ``assumed``, its mix and limits, its entries and a reader of
a ``tdax.*`` span, and runs the copy in a subprocess whose ``benchmark``
package is the copy.  No file of the copied ``benchmark/`` may change,
and ``BENCHMARK.json`` keeps every entry it had.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import spec

CELL = "toy-x.capture-x"

JOB = '''"""A stand-in for a second architecture's capture job: the capture
job's window over an entry point of its own."""

import sys

from benchmark.faults import capture_faults
from benchmark.jobs import capture


def entry(images, params, cfg, ids, mask, last, img_pos):
    from tdax_torch.models.qwen_vl import model as port_model
    return port_model.extract_layer_activations(params, cfg, ids, mask, last, images, img_pos)


class Job(capture.Job):
    FAULTS = {kind: make for kind, make in capture_faults(
        __name__, "entry", batch_args=(0, 3, 4, 5, 6)).items() if kind != "state_unchanged"}
    SPANS = ("capture", "decoder")

    @staticmethod
    def tiny(cfg, dtype):
        return {"hidden_size": 48, "num_hidden_layers": 3, "num_attention_heads": 3,
                "kv_channels": 16, "intermediate_size": 128, "vocab_size": 512,
                "layer_norm_epsilon": 1e-06, "rotary_emb_base": 10000, "seq_length": 256,
                "visual": {"image_size": 42, "patch_size": 14, "width": 48, "layers": 1,
                           "heads": 3, "mlp_ratio": 2.0, "output_dim": 48},
                "resampler": {"n_queries": 4, "heads": 3}, "dtype": dtype, "weights": dtype}

    def run_batch(self, i):
        import numpy as np
        import torch
        ids, mask, last, images, img_pos = self.inputs.batch(i)
        with self.spans("h2d"):
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in (ids, mask, last, images, img_pos)]
        with self.spans("forward"), torch.inference_mode():
            acts = sys.modules[__name__].entry(dev[3], self.params, self.port_cfg, *dev[:3],
                                               dev[4])
        with self.spans("readout"):
            return acts.float().cpu().numpy()
'''

READER = '''"""x_block_ms (ms a unit): the kernels of the port's ``tdax.x_block``."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "x_block")
'''

PROBE = '''
import json
import types

import benchmark
from benchmark import faults, program_spans, spec
from benchmark.rehearse import rehearse, tiny_cell
from benchmark.tests import test_bench_spec as t
from benchmark.trace import Trace

CELL = "toy-x.capture-x"
SEED = 2 ** 31 + 11
out = {"package": benchmark.__file__, "cells": t.CELLS}
t.test_top_level_keys()
for section in ("configs", "workloads", "end_to_end", "per_layer"):
    t.test_names_units_and_keys(section)
t.test_metrics_rules()
for name in t.CELLS:
    t.test_cell_files_found(name)
for m in t.SPEC["per_layer"]:
    t.test_metric_reader_found(m["name"])
cell = tiny_cell(CELL)
out["tiny"] = cell.config
result = rehearse(CELL, seed=SEED)
out["sound"] = [result["correct"], result["attempted"]]
out["faults"] = {}
for kind in faults.kinds(cell.job):
    with faults.planted(cell.job, kind):
        out["faults"][kind] = rehearse(CELL, seed=SEED)["correct"]
report = program_spans.report(cell, SEED, "cpu")
out["spans"] = sorted(report["kernel_ms_by_span"])
out["declared_spans"] = list(spec.job(cell.job).SPANS)


def ann(name, ts, dur):
    return {"cat": "user_annotation", "ph": "X", "name": name, "ts": ts, "dur": dur, "tid": 1}


def kernel(corr, at, dur):
    return [{"cat": "cuda_runtime", "ph": "X", "name": "cudaLaunchKernel", "ts": at, "dur": 2,
             "tid": 1, "args": {"correlation": corr}},
            {"cat": "kernel", "ph": "X", "name": "k", "ts": at + 50, "dur": dur, "tid": 7,
             "args": {"correlation": corr}}]


events = [ann("bench.window", 0, 10000), ann("tdax.x_block", 1000, 1000),
          ann("tdax.x_block", 5000, 1000)]
events += kernel(1, 1100, 300) + kernel(2, 5100, 500) + kernel(3, 3000, 700)
ctx = types.SimpleNamespace(trace=Trace(events), work=None, units=2)
out["reader"] = spec.layer_reader("x_block_ms").read(ctx)
print(json.dumps(out))
'''


def _hashes(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add(tmp_path):
    bench = tmp_path / "benchmark"
    (bench / "jobs/capture_x.py").write_text(JOB)
    (bench / "layer_metrics/x_block_ms.py").write_text(READER)
    cfg = json.loads((bench / "configs/qwen-vl-chat.json").read_text())
    cfg.update(name="toy-x", assumed=["resampler.n_queries"],
               deployment="a stand-in of another architecture")
    (bench / "configs/toy-x.json").write_text(json.dumps(cfg))
    mix = {"job": "capture_x", "unit": "sample", "batch_size": 6, "pad_multiple": 64,
           "render_size": 200, "pool_batches": 3, "check_batches": 2, "trace_units": 2,
           "about": "a stand-in mix"}
    (bench / "traffic/capture-x.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits/qwen-vl-chat.capture.json", bench / f"limits/{CELL}.json")
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "toy-x", "source": cfg["source"],
                                 "file": "benchmark/configs/toy-x.json", "reduced": [],
                                 "why": "a stand-in of another architecture"})
    spec_json["workloads"].append({"name": CELL, "config": "toy-x", "traffic": "capture-x",
                                   "chips": 1, "why": "a stand-in cell"})
    spec_json["per_layer"].append({"name": "x_block_ms", "unit": "ms", "better": "lower",
                                   "source": "device_trace", "layer": "model step",
                                   "moves": "samples_per_s", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))


def test_second_job_is_new_files_only(tmp_path):
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path / "benchmark")
    old_spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _add(tmp_path)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(spec.ROOT)])}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["package"].startswith(str(tmp_path))
    assert CELL in out["cells"]
    # its own tiny sizes, not Qwen-VL's
    assert out["tiny"]["hidden_size"] == 48 and out["tiny"]["resampler"]["n_queries"] == 4
    assert out["sound"] == [True, 2 * 6]
    assert out["faults"] == {"half_batch": False, "answer_altered": False}
    assert set(out["declared_spans"]) <= set(out["spans"])
    # (300 + 500) us of the x_block ranges' kernels over 2 units
    assert abs(out["reader"] - 0.4) < 1e-9
    after = _hashes(tmp_path / "benchmark")
    assert {path: after.get(path) for path in before} == before
    new_spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, value in old_spec.items():
        assert new_spec[key][:len(value)] == value if isinstance(value, list) else (
            new_spec[key] == value), key
