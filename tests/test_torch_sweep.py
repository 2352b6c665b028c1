"""The port's sweep (UMAP, silhouette, persistence, run_tda_sweep)
against tdax, on the CPU.

Same numpy inputs from a seed into both packages.  tdax's spectral
jitter is Threefry noise that torch cannot draw, and the 500-epoch
layout amplifies rounding, so parity is held stage by stage on
identical inputs, and end to end with tdax's own init injected:

  * fuzzy graph: W within 5e-4 abs, rho within 1e-4 abs, sigma within
    2e-4 relative plus 1e-6 absolute (the cosine distances differ by ~3e-7 between the two
    matrix products, which the sigma bisection amplifies; on identical
    kNN distances sigma agrees to ~2e-7);
  * spectral embedding before the jitter: per column up to sign, 2e-4;
  * layout from tdax's init and graph, 50 epochs: 1e-3 abs on clouds
    of max-abs 10.  ``_embed`` from tdax's init is held to its own
    stages (its graph against tdax's, its layout exactly the layout of
    that graph), not to tdax's layout: a weight that differs in its 4th
    digit can move an edge's pruning or epochs_per_sample schedule
    across an integer epoch, so the two layouts part discretely within
    10 epochs;
  * silhouette: 1e-5;
  * run_tda_sweep from tdax's init, both reducer modes:
    summary_stats.json with tdax's keys in tdax's order, the same peak
    layer and essential H0 count, silhouettes within 0.03 at every
    layer, max H0 persistence within 5% (100 epochs) or 35% (the
    500-epoch default); and the port's stats equal tdax's persistence
    and silhouette functions applied to the port's own 3-d clouds
    within 1e-5.  Per-layer H1 maxima are not compared across packages:
    whether a 36-point 3-d layout holds a small loop flips with the
    layout's drift (measured: up to 2x at 100 epochs).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.config import SweepConfig as JSweepConfig
from tdax.config import UMAPConfig as JUMAPConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.data.io import activations_to_layer_clouds as j_layer_clouds
from tdax.data.io import load_activations as j_load_activations
from tdax.data.io import save_activations as j_save_activations
from tdax.metrics.persistence import diagram_stats as j_diagram_stats
from tdax.metrics.silhouette import silhouette_jax, silhouette_score as j_silhouette_score
from tdax.ops.rips import rips as j_rips
from tdax.ops.umap import fuzzy as jf
from tdax.ops.umap import layout as jl
from tdax.ops.umap import umap as ju
from tdax.ops.umap.spectral import spectral_init as j_spectral_init
from tdax.pipeline import run_tda_sweep as j_run_tda_sweep

import tdax_torch.ops.umap.umap as tu
from tdax_torch.config import SweepConfig, UMAPConfig
from tdax_torch.data.io import activations_to_layer_clouds, load_activations
from tdax_torch.metrics.persistence import diagram_stats
from tdax_torch.metrics.silhouette import silhouette, silhouette_score
from tdax_torch.ops.umap import fuzzy as tf
from tdax_torch.ops.umap import layout as tl
from tdax_torch.ops.umap.spectral import spectral_embedding, spectral_init
from tdax_torch.pipeline.tda_sweep import (batched_silhouettes, embed_and_silhouettes,
                                           persistence_per_layer, run_tda_sweep)

N_LAYERS, HIDDEN = 4, 64
A, B = ju.find_ab_params(1.0, 0.1)


def _clouds(seed=0, n_clouds=3, n=36, d=HIDDEN):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_clouds, n, d)).astype(np.float32)
    x[:, :9] += 3.0  # one denser group per cloud
    return x


def _t(a):
    return torch.as_tensor(np.array(a))


def _tdax_graph_and_init(x, k=6, metric="cosine", seed=42):
    """tdax's fuzzy graph and spectral init (with its jitter) for one cloud."""
    w, _, _ = jf.fuzzy_simplicial_set(jnp.asarray(x), k, metric)
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return w, j_spectral_init(w, 3, k_init), k_init


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_fuzzy_simplicial_set_matches_tdax(metric):
    xs = _clouds(1)
    w, sigma, rho = tf.fuzzy_simplicial_set(_t(xs), 6, metric)  # batched over clouds
    for i, x in enumerate(xs):
        jw, js, jr = jf.fuzzy_simplicial_set(jnp.asarray(x), 6, metric)
        np.testing.assert_allclose(w[i].numpy(), np.asarray(jw), atol=5e-4, rtol=0)
        np.testing.assert_allclose(sigma[i].numpy(), np.asarray(js), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(rho[i].numpy(), np.asarray(jr), atol=1e-4, rtol=0)
    assert torch.equal(w, w.transpose(-1, -2))


def test_smooth_knn_dist_rho_guards_match_tdax():
    d = np.array([[0.0, 0.0, 0.0, 0.7], [0.0, 0.2, 0.3, 0.4], [0.0, 0.0, 0.0, 0.0]], np.float32)
    for lc in (1.0, 1.5, 0.5):
        s, r = tf.smooth_knn_dist(_t(d), 4.0, local_connectivity=lc)
        js, jr = jf.smooth_knn_dist(jnp.asarray(d), 4.0, local_connectivity=lc)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-7)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-4)


def test_spectral_embedding_matches_tdax_up_to_sign():
    for x in _clouds(2):
        jw, jinit, k_init = _tdax_graph_and_init(x)
        noise = np.asarray(jax.random.normal(k_init, (36, 3), dtype=jnp.float32)) * 1e-4
        want = np.asarray(jinit) - noise
        got = spectral_embedding(_t(jw), 3).numpy()
        sign = np.sign((got * want).sum(0))
        np.testing.assert_allclose(got * sign, want, atol=2e-4)


def test_spectral_init_jitter_is_seeded_and_shared_by_layers():
    w = tf.fuzzy_simplicial_set(_t(_clouds(3)), 6)[0]
    a, b = spectral_init(w, 3, 42), spectral_init(w, 3, 42)
    assert torch.equal(a, b) and a.dtype == torch.float32
    noise = a - spectral_embedding(w, 3)
    assert noise.abs().max() < 1e-3
    torch.testing.assert_close(noise[0], noise[1], atol=1e-6, rtol=0)


def test_epoch_forces_match_tdax():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(7, 3)).astype(np.float32)
    emb[4] = emb[1]  # a duplicate pair: both zero-distance branches fire
    active = rng.random((7, 7)) < 0.5
    np.fill_diagonal(active, False)
    n_neg = np.where(active, rng.integers(0, 6, (7, 7)), 0).astype(np.float32)
    got = tl._epoch_forces(_t(emb), _t(emb), _t(active), _t(n_neg), A, B, 1.0)
    want = jl._epoch_forces(jnp.asarray(emb), jnp.asarray(emb), jnp.asarray(active),
                            jnp.asarray(n_neg), jnp.float32(A), jnp.float32(B), jnp.float32(1.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("move_other", [True, False])
def test_optimize_layout_matches_tdax(move_other):
    xs = _clouds(4, n_clouds=2)
    jw, jinit, _ = _tdax_graph_and_init(xs[0])
    tail = np.asarray(jinit) if move_other else np.asarray(_tdax_graph_and_init(xs[1])[1])
    alpha = 1.0 if move_other else 0.25
    want = jl.optimize_layout(jinit, jnp.asarray(tail), jw, 50, jax.random.PRNGKey(0), A, B,
                              initial_alpha=alpha, move_other=move_other)
    got = tl.optimize_layout(_t(jinit), _t(tail), _t(jw), 50, A, B, initial_alpha=alpha,
                             move_other=move_other)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_embed_from_tdax_init_runs_tdax_stages():
    x = _clouds(5, n_clouds=1)[0]
    _, jinit, _ = _tdax_graph_and_init(x)
    _, jw = ju._embed(jnp.asarray(x), 6, 3, "cosine", 50, jax.random.PRNGKey(42), A, B,
                      1.0, 5, 1.0, 1.0, 1.0)
    got, w = tu._embed(_t(x), 6, 3, "cosine", 50, 42, A, B, 1.0, 5, 1.0, 1.0, 1.0,
                       init=_t(jinit))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=5e-4)
    assert torch.equal(got, tl.optimize_layout(_t(jinit), _t(jinit), w, 50, A, B))


def test_transform_core_matches_tdax():
    xs = _clouds(6, n_clouds=2)
    _, train_emb, _ = _tdax_graph_and_init(xs[1])
    for x in xs:  # a new cloud, and the fit cloud itself (pinned zero diagonal)
        want = ju._transform_core(jnp.asarray(x), jnp.asarray(xs[1]), train_emb, 6, "cosine",
                                  30, jax.random.PRNGKey(0), A, B, 1.0, 5, 1.0, 1.0)
        got = tu._transform_core(_t(x), _t(xs[1]), _t(train_emb), 6, "cosine", 30, A, B,
                                 1.0, 5, 1.0, 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_find_ab_params_matches_tdax():
    assert tu.find_ab_params(1.0, 0.1) == (A, B)


def test_shared_batched_matches_serial_umap_loop():
    xs = _clouds(7)
    cfg = UMAPConfig(n_epochs=30)
    batched = tu.shared_transform_batched(xs, cfg, device="cpu")
    reducer = tu.UMAP.from_config(cfg, device="cpu")
    reducer.n_neighbors = 6
    reducer.fit(xs[-1])
    serial = np.stack([reducer.transform(x) for x in xs])
    np.testing.assert_allclose(batched, serial, atol=1e-5)
    np.testing.assert_allclose(reducer.fit_transform(xs[-1]),
                               tu.fit_transform_batched(xs, cfg, device="cpu")[-1], atol=1e-5)


def test_umap_dense_only():
    with pytest.raises(NotImplementedError, match="sparse"):
        tu.fit_transform_batched(np.zeros((1, 2049, 3), np.float32), device="cpu")


def test_silhouette_matches_tdax_and_sklearn():
    from sklearn.metrics import silhouette_score as sk_silhouette_score
    rng = np.random.default_rng(8)
    xs = rng.normal(size=(3, 36, 3)).astype(np.float32)
    labels = [f"s{i // 6}" for i in range(36)]
    labels[5] = "solo"  # a singleton cluster
    enc = np.unique(labels, return_inverse=True)[1]
    got = silhouette(_t(xs), _t(enc), 7).numpy()
    for i, x in enumerate(xs):
        want = float(silhouette_jax(jnp.asarray(x), jnp.asarray(enc), 7))
        assert abs(got[i] - want) <= 1e-5
        assert abs(silhouette_score(x, labels, device="cpu") - j_silhouette_score(x, labels)) <= 1e-5
        assert abs(got[i] - sk_silhouette_score(x, labels)) <= 1e-5
    sils = batched_silhouettes(xs, {"shape": labels}, device="cpu")
    np.testing.assert_allclose(sils["shape"], got, atol=0)


def test_diagram_stats_match_tdax():
    x = np.random.default_rng(9).normal(size=(36, 3))
    dgms = persistence_per_layer(x[None], maxdim=1)[0]
    assert json.dumps(diagram_stats(dgms, layer=3)) == json.dumps(j_diagram_stats(dgms, layer=3))
    assert list(diagram_stats([np.zeros((0, 2))])) == list(j_diagram_stats([np.zeros((0, 2))]))


# --- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_pipeline.py's synthetic activations: layer 2 clustered by shape."""
    root = tmp_path_factory.mktemp("torch_sweep")
    metadata = j_generate_dataset(JDatasetConfig(data_dir=str(root / "data")), render=False)
    rng = np.random.default_rng(0)
    ids = [m["id"] for m in metadata]
    keys = sorted({m["shape"] for m in metadata})
    centers = rng.normal(size=(len(keys), HIDDEN)) * 5
    acts = rng.normal(size=(N_LAYERS, len(ids), HIDDEN))
    for j, m in enumerate(metadata):
        acts[2, j] = centers[keys.index(m["shape"])] + rng.normal(0, 0.3, HIDDEN)
    npz = str(root / "all_activations.npz")
    j_save_activations(npz, acts.astype(np.float32), ids, metadata)
    return root, str(root / "data" / "metadata.json"), npz


def _meta(meta_path, result):
    with open(meta_path) as f:
        by_id = {m["id"]: m for m in json.load(f)}
    return [by_id[i] for i in result["sample_ids"]]


def _inject_tdax_init(monkeypatch, clouds, mode):
    """Make the port start from tdax's spectral init (Threefry jitter
    included) for the clouds the sweep fits."""
    fit = clouds if mode == "per_layer" else clouds[-1:]
    k_init, _ = jax.random.split(jax.random.PRNGKey(42))
    inits = []
    for x in fit:
        w, _, _ = jf.fuzzy_simplicial_set(jnp.asarray(x, jnp.float32), 6, "cosine")
        inits.append(np.asarray(j_spectral_init(w, 3, k_init)))
    init = torch.as_tensor(np.stack(inits) if mode == "per_layer" else np.array(inits[0]))

    def fake(w, n_components, random_state):
        assert tuple(w.shape[:-1]) == tuple(init.shape[:-1])
        return init.to(w.device)
    monkeypatch.setattr(tu, "spectral_init", fake)


@pytest.mark.parametrize("mode,n_epochs", [("per_layer", 100), ("shared", 100),
                                           ("per_layer", None)])
def test_run_tda_sweep_matches_tdax(workspace, tmp_path, monkeypatch, mode, n_epochs):
    root, meta_path, npz = workspace
    clouds, _ = j_layer_clouds(j_load_activations(npz), N_LAYERS)
    _inject_tdax_init(monkeypatch, clouds, mode)
    save = n_epochs is None
    jcfg = JSweepConfig(n_layers=N_LAYERS, output_dir=str(tmp_path / "tdax"),
                        umap=JUMAPConfig(n_epochs=n_epochs), reducer_mode=mode,
                        save_diagrams=save)
    cfg = SweepConfig(n_layers=N_LAYERS, output_dir=str(tmp_path / "port"),
                      umap=UMAPConfig(n_epochs=n_epochs), reducer_mode=mode, save_diagrams=save)
    want = j_run_tda_sweep(j_load_activations(npz), meta_path, jcfg, verbose=False)
    got = run_tda_sweep(load_activations(npz), meta_path, cfg, verbose=False, device="cpu")

    assert got["peak_layer"] == want["peak_layer"] == 2
    assert got["sample_ids"] == want["sample_ids"]
    with open(tmp_path / "tdax" / "summary_stats.json") as f:
        jstats = json.load(f)
    with open(tmp_path / "port" / "summary_stats.json") as f:
        stats = json.load(f)
    assert len(stats) == len(jstats) == N_LAYERS
    h0_tol = 0.05 if n_epochs else 0.35
    for s, j in zip(stats, jstats):
        assert list(s) == list(j)  # tdax's keys in tdax's order
        assert s["layer"] == j["layer"] and s["n_h0_features"] == j["n_h0_features"]
        for key in ("silhouette_shape", "silhouette_color"):
            assert abs(s[key] - j[key]) <= 0.03, key
        assert abs(s["max_h0_persistence"] - j["max_h0_persistence"]) <= (
            h0_tol * j["max_h0_persistence"])

    # stages 2-3 on the port's own clouds: tdax's functions give its stats
    clouds_3d = got["clouds_3d"]
    sils = batched_silhouettes(clouds_3d, {"shape": [m["shape"] for m in _meta(meta_path, got)]},
                               device="cpu")["shape"]
    for i, s in enumerate(stats):
        j = j_diagram_stats(j_rips(clouds_3d[i].astype(np.float64), maxdim=1)["dgms"], layer=i)
        for key, v in j.items():
            np.testing.assert_allclose(s[key], v, rtol=1e-5, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(s["silhouette_shape"], sils[i], atol=1e-6)
    out = tmp_path / "port"
    assert (out / "summary_evolution_plot.png").exists() == save
    for i in range(N_LAYERS):
        assert (out / "point_clouds_3d" / f"layer_{i}_cloud.npy").exists()
        assert (out / "diagrams" / f"layer_{i}_diagram.png").exists() == save


def test_run_tda_sweep_peak_rules_and_pt_input(workspace, tmp_path):
    """The reference's .pt schema in, both peak rules, the log events."""
    root, meta_path, npz = workspace
    pt = str(tmp_path / "acts.pt")
    data = load_activations(npz)
    torch.save({sid: {"metadata": e["metadata"],
                      "activations": {k: torch.as_tensor(v, dtype=torch.float32)
                                      for k, v in e["activations"].items()}}
                for sid, e in data.items()}, pt)
    log = tmp_path / "events.jsonl"
    os.environ["TDAX_LOG"] = str(log)
    try:
        res = run_tda_sweep(load_activations(pt), meta_path,
                            SweepConfig(n_layers=8, output_dir=str(tmp_path / "o"),
                                        umap=UMAPConfig(n_epochs=30), save_diagrams=False,
                                        peak_rule="max_h1"),
                            verbose=False, device="cpu")
    finally:
        del os.environ["TDAX_LOG"]
    assert len(res["stats"]) == N_LAYERS  # the data has fewer layers than asked
    assert res["peak_layer"] == int(np.argmax([s["max_h1_persistence"] for s in res["stats"]]))
    events = [json.loads(line)["event"] for line in log.read_text().splitlines()]
    assert events == ["embed", "persistence"]
    clouds, ids = activations_to_layer_clouds(data, N_LAYERS)
    jclouds, jids = j_layer_clouds(j_load_activations(npz), N_LAYERS)
    assert ids == jids and np.array_equal(clouds, jclouds)


def test_embed_and_silhouettes_matches_separate_stages():
    xs = _clouds(10, n_clouds=2)
    labels = [f"s{i // 6}" for i in range(36)]
    cfg = SweepConfig(umap=UMAPConfig(n_epochs=20))
    embs, sils = embed_and_silhouettes(xs, cfg, {"shape": labels}, device="cpu")
    assert embs.shape == (2, 36, 3) and embs.dtype == np.float32
    np.testing.assert_allclose(embs, tu.fit_transform_batched(xs, cfg.umap, device="cpu"),
                               atol=0)
    np.testing.assert_allclose(sils["shape"],
                               batched_silhouettes(embs, {"shape": labels}, device="cpu")["shape"],
                               atol=1e-6)
