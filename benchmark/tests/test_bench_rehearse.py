"""Each cell end to end on the CPU at the tiny size through the rehearsal
path, traced and untraced; the measurement path refuses without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.rehearse import rehearse

CELLS = [w["name"] for w in spec.load()["workloads"]]
BIG_SEED = 2 ** 31 + 77
# the port's QwenVLConfig.tiny(): every Qwen-VL rehearsal's sizes
QWEN_TINY = {
    "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4, "kv_channels": 16,
    "intermediate_size": 256, "vocab_size": 512, "layer_norm_epsilon": 1e-06,
    "rotary_emb_base": 10000, "seq_length": 512,
    "visual": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2, "heads": 2,
               "mlp_ratio": 2.0, "output_dim": 64},
    "resampler": {"n_queries": 16, "heads": 4},
}


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearses(name):
    result = rehearse(name, seed=BIG_SEED, units=3)
    cell = spec.cell(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 3 * cell.traffic["batch_size"] and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.limits["limits"])
    # a CPU run names no device
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearses_traced(name):
    result = rehearse(name, seed=3, trace=True)
    assert result["correct"]
    # no device operation on the CPU: every reader returns nothing
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert result["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    from benchmark.rehearse import tiny_cell
    cell = tiny_cell(name)
    a = spec.job(cell.job)(cell, BIG_SEED, "cpu")
    b = spec.job(cell.job)(cell, BIG_SEED, "cpu")
    wa, wb = a.weights(), b.weights()
    if not isinstance(wa, dict):
        wa, wb = wa.build(), wb.build()
    assert all((x == y).all() for x, y in zip(_leaves(wa), _leaves(wb)))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("name", [n for n in CELLS if spec.cell(n).job in ("capture", "train")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen_jobs_rehearse_on_qwen_tiny(name, dtype):
    from benchmark.rehearse import tiny_cell
    cfg = spec.cell(name).config
    weights = dtype if cfg["weights"] == cfg["dtype"] else cfg["weights"]
    assert tiny_cell(name, dtype).config == {**QWEN_TINY, "dtype": dtype, "weights": weights}


def test_measurement_path_refuses_without_card():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_result_line_is_json_with_checks_last():
    result = rehearse(CELLS[0], seed=9)
    line = json.dumps(result)
    assert list(json.loads(line))[-1] == "checks"
