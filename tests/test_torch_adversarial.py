"""The port's adversarial workflow against tdax, on the CPU: the 720
pairs, the per-condition clouds and the 4-condition sweep.

The sweep runs on the 40-pair toy capture of
tests/test_golden_regression.py (two base images, tdax's tiny f32
capture), with tdax's spectral init (its Threefry jitter included)
injected as in tests/test_torch_sweep.py, at the default 500 epochs.
Held: summary.json with tdax's keys in tdax's order, the sample count of
every condition exactly, every silhouette within 0.03 of tdax's (NaN
where tdax's is NaN: a condition whose labels form fewer than two
classes, or only singletons), and stages 2-3 on the port's own 3-d
clouds equal to tdax's silhouette and persistence functions at rtol 1e-5.
Per-layer H1 maxima are not compared across packages (see
tests/test_torch_sweep.py: a small loop in a tiny layout flips with the
layout's drift).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.config import ExtractConfig as JExtractConfig
from tdax.config import SweepConfig as JSweepConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.data.adversarial import condition_counts as j_condition_counts
from tdax.data.adversarial import generate_adversarial_metadata as j_generate_adversarial
from tdax.data.io import activations_to_layer_clouds as j_layer_clouds
from tdax.metrics.persistence import get_persistence as j_get_persistence
from tdax.metrics.silhouette import silhouette_jax as j_silhouette
from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.ops.rips import rips as j_rips
from tdax.ops.umap.spectral import spectral_init as j_spectral_init
from tdax.pipeline.adversarial import run_adversarial_sweep as j_run_adversarial_sweep
from tdax.pipeline.extract import extract_activations as j_extract_activations

import tdax_torch.ops.umap.umap as tu
from tdax_torch.config import DatasetConfig, SweepConfig
from tdax_torch.data.adversarial import (CONDITIONS, condition_counts,
                                         generate_adversarial_metadata)
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.data.io import activations_to_layer_clouds
from tdax_torch.pipeline.adversarial import LABEL_KEYS, run_adversarial_sweep

STAT_KEYS = ["layer", "n_h1_features", "max_h1_persistence", "max_h0_persistence",
             "silhouette_img_color", "silhouette_img_shape", "silhouette_txt_color",
             "silhouette_txt_shape"]
SIL_TOL = 0.03


def test_metadata_matches_tdax(tmp_path):
    base = generate_dataset(DatasetConfig(data_dir=str(tmp_path / "port")), render=False)
    jbase = j_generate_dataset(JDatasetConfig(data_dir=str(tmp_path / "tdax")), render=False)
    ds = DatasetConfig(data_dir=str(tmp_path / "port"))
    got = generate_adversarial_metadata(base, ds, save=True)
    want = j_generate_adversarial(base, JDatasetConfig(data_dir=str(tmp_path / "tdax")),
                                  save=True)
    assert got == want  # ids, order, fields
    assert len(got) == 720
    assert condition_counts(got) == j_condition_counts(want) == {
        "matched": 36, "color_mismatch": 180, "shape_mismatch": 180, "both_mismatch": 324}
    assert list(condition_counts(got)) == list(CONDITIONS)
    with open(ds.adversarial_metadata_path) as f:
        assert json.load(f) == got
    with open(tmp_path / "tdax" / "adversarial_metadata.json") as f:
        assert json.load(f) == got
    # only the bound images are bases
    assert generate_adversarial_metadata(jbase[36:], save=False) == []


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """tests/test_golden_regression.py's 40 pairs and tdax's toy capture."""
    root = tmp_path_factory.mktemp("torch_adversarial")
    ds = JDatasetConfig(data_dir=str(root / "data"))
    bound = [m for m in j_generate_dataset(ds) if m["type"] == "bound"]
    adv = j_generate_adversarial(bound, ds, save=False)
    base_ids = {bound[0]["id"], bound[1]["id"]}
    adv = [m for m in adv if m["base_id"] in base_ids]
    assert len(adv) == 40  # 2 x (1 + 5 + 5 + 9)
    results = j_extract_activations(
        adv, str(root / "adv_acts.pt"), JConfig.tiny(dtype="float32"),
        JExtractConfig(model_dir=None, batch_size=8, save_interval=1000), verbose=False)
    return results


def test_layer_clouds_by_condition_match_tdax(capture):
    for condition in CONDITIONS:
        got, ids = activations_to_layer_clouds(capture, 4, point_cloud_type=None,
                                               condition=condition)
        want, jids = j_layer_clouds(capture, 4, point_cloud_type=None, condition=condition)
        assert ids == jids and ids == sorted(ids)
        np.testing.assert_array_equal(got, want)
    # the condition filter takes precedence over the type filter, as in tdax
    got, ids = activations_to_layer_clouds(capture, 2, condition="matched")
    assert ids == j_layer_clouds(capture, 2, condition="matched")[1] and len(ids) == 2


def _inject_tdax_init(monkeypatch):
    """The port's UMAP starts from tdax's spectral init (Threefry jitter
    included) of each layer's graph."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(42))

    def fake(w, n_components, random_state):
        assert random_state == 42
        return torch.stack([torch.as_tensor(np.array(j_spectral_init(
            jnp.asarray(wl.numpy()), n_components, k_init))) for wl in w])
    monkeypatch.setattr(tu, "spectral_init", fake)


def test_run_adversarial_sweep_matches_tdax(capture, tmp_path, monkeypatch):
    _inject_tdax_init(monkeypatch)
    jout, out = tmp_path / "tdax", tmp_path / "port"
    want = j_run_adversarial_sweep(capture, str(jout), JSweepConfig(output_dir=str(jout)),
                                   verbose=False)
    got = run_adversarial_sweep(capture, str(out), SweepConfig(save_diagrams=False),
                                verbose=False, device="cpu")
    summary = json.loads((out / "summary.json").read_text())
    jsummary = json.loads((jout / "summary.json").read_text())
    assert list(summary) == list(jsummary) == ["condition_stats", "n_samples_per_condition"]
    assert summary["n_samples_per_condition"] == jsummary["n_samples_per_condition"] == {
        "matched": 2, "color_mismatch": 10, "shape_mismatch": 10, "both_mismatch": 18}
    assert list(summary["n_samples_per_condition"]) == list(CONDITIONS)
    assert list(got["condition_stats"]) == list(want["condition_stats"]) == list(CONDITIONS)
    for condition in CONDITIONS:
        stats = summary["condition_stats"][condition]
        jstats = jsummary["condition_stats"][condition]
        assert len(stats) == len(jstats) == 4
        assert json.loads((out / condition / "layer_stats.json").read_text()) == stats
        for s, j in zip(stats, jstats):
            assert list(s) == list(j) == STAT_KEYS
            for key in STAT_KEYS[4:]:
                np.testing.assert_allclose(s[key], j[key], rtol=0, atol=SIL_TOL,
                                           err_msg=f"{condition} {key}")

        # stages 2-3 on the port's own clouds: tdax's functions give its stats
        _, ids = j_layer_clouds(capture, 4, point_cloud_type=None, condition=condition)
        labels = {k: [capture[i]["metadata"][k] for i in ids] for k in LABEL_KEYS}
        for i, s in enumerate(stats):
            cloud = np.load(out / condition / "point_clouds" / f"layer_{i}_cloud.npy")
            assert cloud.shape[0] == len(ids) and np.isfinite(cloud).all()
            dgms = j_rips(cloud.astype(np.float64), maxdim=1)["dgms"]
            h1, max_h1 = j_get_persistence(dgms[1])
            np.testing.assert_allclose([s["n_h1_features"], s["max_h1_persistence"],
                                        s["max_h0_persistence"]],
                                       [len(h1), max_h1, j_get_persistence(dgms[0])[1]],
                                       rtol=1e-5, atol=1e-6)
            for key in LABEL_KEYS:
                uniq, enc = np.unique(labels[key], return_inverse=True)
                want_sil = float(j_silhouette(jnp.asarray(cloud), jnp.asarray(enc), len(uniq)))
                np.testing.assert_allclose(s[f"silhouette_{key}"], want_sil,
                                           rtol=1e-5, atol=1e-6, err_msg=key)

    # the artifact tree; no PNG at all without diagrams
    assert (out / "comparison").is_dir()
    assert not (out / "comparison" / "all_conditions_comparison.png").exists()
    assert (jout / "comparison" / "all_conditions_comparison.png").exists()
    for condition in CONDITIONS:
        assert (out / condition / "diagrams").is_dir()
        assert not list((out / condition / "diagrams").iterdir())
    assert not list(out.rglob("*.png"))


def test_run_adversarial_sweep_draws_the_figures_with_diagrams(capture, tmp_path):
    out = tmp_path / "port"
    cfg = SweepConfig(n_layers=2, save_clouds=False)
    summary = run_adversarial_sweep(capture, str(out), cfg, verbose=False, device="cpu")
    assert all(len(s) == 2 for s in summary["condition_stats"].values())
    assert (out / "comparison" / "all_conditions_comparison.png").stat().st_size > 0
    for condition in CONDITIONS:
        assert sorted(p.name for p in (out / condition / "diagrams").iterdir()) == [
            "layer_0_diagram.png", "layer_1_diagram.png"]
        assert not list((out / condition / "point_clouds").iterdir())


def test_adversarial_sweep_refuses_to_run_without_a_card(capture, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_adversarial_sweep(capture, str(tmp_path / "o"))
