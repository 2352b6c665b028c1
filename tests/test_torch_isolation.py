"""The port stands alone: no ``jax``, nothing of ``tdax``, and no quiet
CPU fallback when no card is present."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from tdax_torch import runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys, tempfile, os
import tdax_torch
from tdax_torch.config import DatasetConfig, ExtractConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.pipeline.extract import extract_activations

with tempfile.TemporaryDirectory() as tmp:
    md = generate_dataset(DatasetConfig(data_dir=os.path.join(tmp, "d")))[:3]
    res = extract_activations(md, os.path.join(tmp, "a.pt"), QwenVLConfig.tiny(dtype="float32"),
                              ExtractConfig(batch_size=2), device="cpu",
                              verbose=False)
    assert len(res) == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "tdax" or m.startswith("tdax."))
print("LOADED:" + ",".join(bad))
"""

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|tdax)(?:[.\s,]|$)", re.MULTILINE)


def test_port_never_loads_jax_or_tdax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED:\n" in proc.stdout, proc.stdout


def _sources():
    files = sorted((ROOT / "tdax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_sources_import_no_jax_or_tdax():
    offenders = []
    for path in _sources():
        for m in _IMPORT.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("from tdax.config import X")
    assert not _IMPORT.search("from tdax_torch.config import X")


def test_get_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.get_device("cuda")
    assert runtime.get_device("cpu") == torch.device("cpu")


def test_get_device_turns_tf32_off():
    runtime.get_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_entry_point_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    """The capture entry point does not carry on quietly on the CPU."""
    from tdax_torch.pipeline.extract import extract_activations
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_activations([], str(tmp_path / "a.pt"))
