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
import numpy as np
import tdax_torch
# import tdax_torch stays light: no plotting, no scipy, no module of the port
assert not [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "scipy")
            or m.startswith("tdax_torch.")]
from tdax_torch.config import DatasetConfig, ExtractConfig, SweepConfig, UMAPConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.data.io import load_activations
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.generate import generate
from tdax_torch.models.qwen_vl.model import init_params
from tdax_torch.models.qwen_vl.quantize import quantize_params
from tdax_torch.pipeline.extract import extract_activations
from tdax_torch.pipeline.scale import rips_at_scale
from tdax_torch.pipeline.tda_sweep import run_tda_sweep

with tempfile.TemporaryDirectory() as tmp:
    ds = DatasetConfig(data_dir=os.path.join(tmp, "d"))
    md = generate_dataset(ds)
    res = extract_activations(md[:3], os.path.join(tmp, "a.pt"),
                              QwenVLConfig.tiny(dtype="float32"),
                              ExtractConfig(batch_size=2), device="cpu",
                              verbose=False)
    assert len(res) == 3
    res = extract_activations(md[:2], os.path.join(tmp, "q.pt"),
                              QwenVLConfig.tiny(dtype="float32"),
                              ExtractConfig(batch_size=2, quantize_int8=True), device="cpu",
                              verbose=False)
    assert len(res) == 2
    import torch
    cfg = QwenVLConfig.tiny(dtype="float32")
    ids = torch.randint(1, cfg.vocab_size, (2, 6))
    toks = generate(quantize_params(init_params(cfg, "cpu")), cfg, ids, torch.ones_like(ids),
                    max_new_tokens=3, kv_int8=True)
    assert toks.shape == (2, 3)
    rng = np.random.default_rng(0)
    data = {m["id"]: {"metadata": m, "activations": {f"layer_{i}": rng.normal(size=16)
                                                     for i in range(2)}} for m in md}
    out = run_tda_sweep(data, ds.metadata_path,
                        SweepConfig(n_layers=2, output_dir=os.path.join(tmp, "sweep"),
                                    umap=UMAPConfig(n_epochs=5), save_diagrams=False),
                        verbose=False, device="cpu")
    assert len(out["stats"]) == 2
    dgms = rips_at_scale(rng.normal(size=(40, 6)), maxdim=1, device="cpu")["dgms"]
    assert len(dgms) == 2
    from tdax_torch.pipeline.scale import rips_at_scale_sparse
    for kw in ({}, {"fused_max": 0, "block_rows": 16}):
        sp = rips_at_scale_sparse(rng.normal(size=(40, 6)), maxdim=2, target_degree=8,
                                  device="cpu", **kw)
        assert len(sp["dgms"]) == 3 and sp["n_edges"] > 0
    from tdax_torch.metrics.persistence import bottleneck_distance
    bars = np.sort(rng.random((1500, 2)), axis=1)
    assert bottleneck_distance(bars, bars + 1e-4) <= 1e-4 + 1e-12
    from tdax_torch.parallel import default_optimizer, train_loop, warmup_cosine_lr
    ids = torch.randint(1, 64, (2, 8))
    ck = os.path.join(tmp, "train_ck")
    _, st, losses = train_loop(init_params(cfg, "cpu", with_visual=False), cfg,
                               lambda i: {"input_ids": ids, "attn_mask": torch.ones_like(ids)},
                               2, default_optimizer(warmup_cosine_lr(1e-3, 1, 4)),
                               checkpoint_path=ck, checkpoint_every=1, device="cpu")
    assert len(losses) == 2 and st.count == 2 and os.path.exists(ck + ".npz")
    # a tiny .bin snapshot, loaded; the adversarial capture from it and its sweep
    import pathlib
    import chip_smoke
    from tdax_torch.data.adversarial import generate_adversarial_metadata
    from tdax_torch.models.qwen_vl.convert import load_qwen_checkpoint
    from tdax_torch.pipeline.adversarial import run_adversarial_sweep
    snap = os.path.join(tmp, "snapshot")
    chip_smoke.write_bin_snapshot(chip_smoke.hf_state(cfg, "cpu"), pathlib.Path(snap), 100_000)
    assert len(os.listdir(snap)) > 2
    assert load_qwen_checkpoint(snap, cfg, "cpu")["layers"]["mlp_w1"].shape == (4, 64, 128)
    adv = [m for m in generate_adversarial_metadata(md, ds, save=False)
           if m["base_id"] in ("red_cube", "red_sphere")]
    res = extract_activations(adv, os.path.join(tmp, "adv.pt"), cfg,
                              ExtractConfig(model_dir=snap, batch_size=8, save_interval=16),
                              device="cpu", verbose=False)
    summary = run_adversarial_sweep(res, os.path.join(tmp, "adv_sweep"),
                                    SweepConfig(n_layers=2, umap=UMAPConfig(n_epochs=5),
                                                save_diagrams=False),
                                    verbose=False, device="cpu")
    assert summary["n_samples_per_condition"] == {"matched": 2, "color_mismatch": 10,
                                                  "shape_mismatch": 10, "both_mismatch": 18}
    # the reference's remaining surface: package names, geometry, Wasserstein,
    # the peak layer's HTML of the sweep above
    import tdax_torch.data, tdax_torch.metrics, tdax_torch.viz
    from tdax_torch.metrics import compute_intrinsic_dimensionality, matrix_entropy
    from tdax_torch.pipeline.report import legacy_sweep_config, visualize_peak_layer
    x = rng.normal(size=(2, 12, 6))
    assert compute_intrinsic_dimensionality(x, device="cpu").shape == (2,)
    assert matrix_entropy(x, 2.0, device="cpu").shape == (2,)
    assert tdax_torch.wasserstein_distance(out["diagrams"][0][1], out["diagrams"][1][1]) >= 0
    assert tdax_torch.rips(rng.normal(size=(10, 3)))["dgms"][0].shape == (10, 2)
    assert legacy_sweep_config(data).reducer_mode == "shared"
    html = visualize_peak_layer(1, os.path.join(tmp, "sweep"), ds.metadata_path,
                                png_fallback=False)
    assert all(os.path.exists(p) for p in html)
    assert "matplotlib" not in sys.modules
    # the edge-list UMAP: a fit and a transform past a lowered threshold
    from tdax_torch.ops.umap import UMAP
    from tdax_torch.ops.umap import sparse_path
    u = UMAP(n_neighbors=5, n_epochs=5, device="cpu")
    u.sparse_threshold = 16
    emb = u.fit_transform(rng.normal(size=(40, 6)))
    assert emb.shape == (40, 2) and sparse_path.LAST_TIMINGS["init_iterations"] > 0
    assert u.transform(rng.normal(size=(20, 6))).shape == (20, 2)
    # W8A8: a tiny capture with int8 activations; the fallback Rips backends
    from tdax_torch.models.qwen_vl.quantize import set_w8a8
    from tdax_torch.ops import quant_matmul
    set_w8a8(True)
    try:
        before = quant_matmul.LAUNCHES_INT8
        res = extract_activations(md[:2], os.path.join(tmp, "w8a8.pt"), cfg,
                                  ExtractConfig(batch_size=2, quantize_int8=True), device="cpu",
                                  verbose=False)
        assert len(res) == 2 and quant_matmul.LAUNCHES_INT8 > before
    finally:
        set_w8a8(False)
    from tdax_torch.config import RipsConfig
    from tdax_torch.ops.rips import rips
    from tdax_torch.ops.rips.tiny_device import rips_tiny_batched
    assert len(rips(rng.normal(size=(7, 3)), maxdim=4, backend="python")["dgms"]) == 5
    assert len(rips_tiny_batched(rng.normal(size=(2, 10, 3)), maxdim=2, device="cpu")[0]) == 3
    out = run_tda_sweep(data, ds.metadata_path,
                        SweepConfig(n_layers=2, output_dir=os.path.join(tmp, "sweep_dev"),
                                    umap=UMAPConfig(n_epochs=5), save_diagrams=False,
                                    rips=RipsConfig(backend="device")),
                        verbose=False, device="cpu")
    assert len(out["stats"]) == 2
    # a world of one over gloo: the extraction's dp path (gather, rank 0 writes)
    from tdax_torch.parallel import mesh
    mesh.init_distributed("cpu", rank=0, world_size=1, store_path=os.path.join(tmp, "store"))
    try:
        res = extract_activations(md[:3], os.path.join(tmp, "dp.pt"), cfg,
                                  ExtractConfig(batch_size=2), device="cpu", verbose=False)
        assert len(res) == 3 and mesh.COLLECTIVES == {"gloo.all_gather": 2}
    finally:
        mesh.shutdown()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "tdax" or m.startswith("tdax."))
print("LOADED:" + ",".join(bad))
print("LAZY:" + ",".join(sorted(m for m in ("transformers", "safetensors") if m in sys.modules)))
"""

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|tdax)(?:[.\s,]|$)", re.MULTILINE)


def test_port_never_loads_jax_or_tdax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED:\n" in proc.stdout, proc.stdout
    assert "LAZY:\n" in proc.stdout, proc.stdout  # neither is needed without their files


def _sources():
    files = sorted((ROOT / "tdax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"tdax_torch/ops/quant_matmul.py", "tdax_torch/models/qwen_vl/quantize.py",
            "tdax_torch/models/qwen_vl/generate.py", "tdax_torch/parallel/train.py",
            "tdax_torch/utils/checkpoint.py", "tdax_torch/models/qwen_vl/convert.py",
            "tdax_torch/data/adversarial.py", "tdax_torch/pipeline/adversarial.py",
            "tdax_torch/metrics/geometry.py", "tdax_torch/viz/scatter3d.py",
            "tdax_torch/pipeline/report.py", "tdax_torch/ops/rips/sparse.py",
            "tdax_torch/pipeline/scale.py", "tdax_torch/metrics/persistence.py",
            "tdax_torch/ops/umap/sparse_path.py", "tdax_torch/ops/umap/lobpcg.py",
            "tdax_torch/ops/rips/reference.py", "tdax_torch/ops/rips/tiny_device.py",
            "tdax_torch/ops/rips/api.py", "tdax_torch/ops/distances.py",
            "tdax_torch/parallel/mesh.py", "tdax_torch/models/qwen_vl/tp.py"} <= names
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


_TOP_LEVEL_LAZY = re.compile(r"^(?:import|from)\s+(transformers|safetensors)\b", re.MULTILINE)


def test_transformers_and_safetensors_are_imported_only_where_used():
    """The card's machine has no ``transformers``: the tokenizer adapter
    and the safetensors reader import theirs inside the function that
    needs it, never at a module's top level."""
    users = {}
    for path in _sources():
        text = path.read_text()
        assert not _TOP_LEVEL_LAZY.search(text), path
        for name in ("transformers", "safetensors"):
            if re.search(rf"^\s+(?:import|from)\s+{name}\b", text, re.MULTILINE):
                users.setdefault(name, []).append(str(path.relative_to(ROOT)))
    assert users == {"transformers": ["tdax_torch/models/qwen_vl/tokenizer.py"],
                     "safetensors": ["tdax_torch/models/qwen_vl/convert.py"]}


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


def test_sweep_and_scale_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    """``python -m tdax_torch sweep``, ``run_tda_sweep`` and
    ``rips_at_scale`` need a card unless they are asked for the CPU."""
    import numpy as np
    from tdax_torch.__main__ import main
    from tdax_torch.pipeline.scale import rips_at_scale
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tda_sweep({}, str(tmp_path / "metadata.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rips_at_scale(np.zeros((5, 3), np.float32))
    assert len(rips_at_scale(np.eye(5, dtype=np.float32), maxdim=1, device="cpu")["dgms"]) == 2


def test_sweep_command_runs_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """``python -m tdax_torch sweep --device cpu`` on a captured .npz."""
    import json

    import numpy as np
    from tdax_torch.__main__ import main
    from tdax_torch.config import DatasetConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.data.io import save_activations_npz
    monkeypatch.chdir(tmp_path)
    ds = DatasetConfig()
    md = generate_dataset(ds)
    acts = np.random.default_rng(1).normal(size=(3, len(md), 16)).astype(np.float32)
    save_activations_npz(ds.activations_path.replace(".pt", ".npz"), acts,
                         [m["id"] for m in md], md)
    main(["sweep", "--device", "cpu"])
    stats = json.loads((tmp_path / "tda_debug_output" / "summary_stats.json").read_text())
    assert [s["layer"] for s in stats] == [0, 1, 2]
    assert (tmp_path / "tda_debug_output" / "diagrams" / "layer_2_diagram.png").exists()


def test_extract_int8_command_runs_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """``python -m tdax_torch extract --int8 --toy --device cpu`` end to
    end, after ``python -m tdax_torch generate``; without ``--device cpu``
    and without a card it refuses."""
    import numpy as np
    from tdax_torch.__main__ import main
    from tdax_torch.config import DatasetConfig
    from tdax_torch.data.io import load_activations_npz
    monkeypatch.chdir(tmp_path)
    main(["generate"])
    main(["extract", "--int8", "--toy", "--device", "cpu"])
    acts, ids, _ = load_activations_npz(DatasetConfig().activations_path.replace(".pt", ".npz"))
    assert acts.shape == (4, 48, 64) and len(ids) == 48 and np.isfinite(acts).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["extract", "--int8", "--toy"])


def test_train_step_refuses_to_run_without_a_card(monkeypatch):
    """make_train_step and train_loop run on the card unless asked for
    the CPU: asked for CUDA, or for nothing, with no card they raise."""
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.parallel import default_optimizer, make_train_step, train_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = QwenVLConfig.tiny(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, default_optimizer(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, default_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop({}, cfg, lambda i: {}, 1)
