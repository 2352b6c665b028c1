"""The edge-list UMAP's mesh variants (``sparse_path``'s ``mesh=``) against
tdax's, on the CPU.

tdax runs its ``shard_map`` variants on the conftest's 8 virtual XLA
devices; the port runs a gloo world of 8 ranks and one of a single rank
(``torch_parallel_worlds``), each spawned once per test session.  The
numpy inputs come from seeds.  Checks and their tolerances:

  * ``knn_blocked`` / ``knn_blocked_cross`` over 8 ranks at n = 205 and
    77 (neither divides: the last shares are padded with copies of row
    0), both metrics: bitwise the port's one-device lists, and against
    tdax's ``mesh=`` call within ``KNN_TOL`` (tests/test_torch_umap_sparse.py's
    f32 expansion-form tolerance, index sets equal where the k-th gap is
    clear of it);
  * the edge layout at tdax's 240-point case (tests/test_umap_sparse.py's
    ``test_sparse_layout_mesh_matches_single_device``, 100 epochs): over
    8 ranks correlated > 0.999 with the one-device layout and silhouette
    > 0.7, tdax's bars; from tdax's edges, init and draws (``_negatives``)
    over 50 epochs within ``LAYOUT_TOL`` of tdax's sharded layout (the
    one-device test's epochs: by 100 the two packages' one-device layouts
    themselves lie 0.57 apart, the epochs amplifying an ulp); with one
    rank bitwise one device;
  * the fixed-tail layout at 64 and 53 new points over 8 ranks: bitwise
    one device (the draws sliced from their one-device shape);
  * ``embed_sparse(mesh=)`` over 8 ranks: the same clusters as one device
    (silhouette > 0.7, correlation of pairwise distances > 0.999);
    ``transform_sparse(mesh=)`` bitwise one device; both bitwise in a
    world of one, every rank holding the same result.
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tdax.ops.umap import sparse_path as js
from tdax.ops.umap.umap import find_ab_params
from tdax.parallel import make_mesh as j_make_mesh

import torch_parallel_worlds as worlds
from tdax_torch.metrics.silhouette import silhouette_score
from tdax_torch.ops.umap import fuzzy as tf
from tdax_torch.ops.umap import sparse_path as ts

A, B = find_ab_params(1.0, 0.1)
K = 8
KNN_TOL = 2e-3      # tests/test_torch_umap_sparse.py's
LAYOUT_TOL = 2e-3   # tests/test_torch_umap_sparse.py's
LAYOUT_CORR, LAYOUT_SIL = 0.999, 0.7   # tests/test_umap_sparse.py:291-320
N_EPOCHS = 100
TDAX_DRAW_EPOCHS = 50
N_TRAIN = 240


def _t(a, long=False):
    return worlds._t(np.asarray(a), long)


def _clusters(seed, n_per, dim, n_clusters=3, scale=8.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * scale
    x = np.concatenate([c + rng.normal(0, noise, (n_per, dim)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(n_clusters), n_per), rng


def _port_layout_inputs(x):
    """The port's edges and PCA init of x (k 10, as tdax's case)."""
    idx, dists = ts.knn_blocked(_t(x), 10, "euclidean")
    sigma, rho = tf.smooth_knn_dist(dists, 10.0, local_connectivity=1.0)
    w = tf.membership_strengths_knn(idx, dists, sigma, rho)
    head, tail, wgt = ts.build_sym_edges(idx.numpy(), w.numpy(), 1.0)
    init = ts.pca_init(_t(x), 2, 1).numpy()
    return {"head": head, "tail": tail, "wgt": wgt, "init": init, "n": len(x),
            "epochs": N_EPOCHS}


def _tdax_layout_inputs(x):
    """tdax's edges, PCA init and per-epoch draws of x (tdax's case)."""
    xj = jnp.asarray(x)
    idx, dists = js.knn_blocked(xj, 10, "euclidean")
    sigma, rho = js.smooth_knn_dist(dists, 10.0, local_connectivity=1.0)
    w = js.membership_strengths_knn(idx, dists, sigma, rho)
    head, tail, wgt = js.build_sym_edges(np.asarray(idx), np.asarray(w), 1.0)
    init = np.asarray(js.pca_init(xj, 2, jax.random.PRNGKey(1)))
    key = jax.random.PRNGKey(2)
    draws = [np.array(jax.random.randint(jax.random.fold_in(key, e), (len(x), ts.NEG_POOL),
                                         0, len(x))) for e in range(TDAX_DRAW_EPOCHS)]
    return {"head": head, "tail": tail, "wgt": wgt, "init": init, "n": len(x),
            "epochs": TDAX_DRAW_EPOCHS, "draws": draws}


def _fixed_tail(seed, n_new, n_train=120, k=8):
    rng = np.random.default_rng(seed)
    return {"train_emb": rng.normal(size=(n_train, 2)).astype(np.float32) * 4,
            "head": np.repeat(np.arange(n_new, dtype=np.int32), k),
            "tail": rng.integers(0, n_train, n_new * k).astype(np.int32),
            "wgt": rng.uniform(0.2, 1.0, n_new * k).astype(np.float32),
            "init": rng.normal(size=(n_new, 2)).astype(np.float32), "epochs": 50}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x, labels, rng9 = _clusters(9, 80, 16)
    x_new = (x[::5] + rng9.normal(0, 0.3, x[::5].shape)).astype(np.float32)
    return {
        "k": K, "ab": (A, B),
        "clouds": {"n205": rng.normal(size=(205, 16)).astype(np.float32),
                   "n77": rng.normal(size=(77, 16)).astype(np.float32)},
        "train": rng.normal(size=(90, 16)).astype(np.float32),
        "layouts": {"port": _port_layout_inputs(x), "tdax": _tdax_layout_inputs(x)},
        "fixed_tail": {"n64": _fixed_tail(13, 64), "n53": _fixed_tail(14, 53)},
        "labels": labels,
        "embed": {"x": x, "x_new": x_new,
                  "train_emb": rng.normal(size=(len(x), 2)).astype(np.float32) * 5,
                  # n_neighbors, n_components, metric, n_epochs, random_state, a, b,
                  # learning_rate, negative_sample_rate, repulsion, local_connectivity,
                  # set_op_mix_ratio
                  "args": (10, 2, "euclidean", N_EPOCHS, 42, A, B, 1.0, 5, 1.0, 1.0, 1.0),
                  "transform_args": (10, "euclidean", 50, 42, A, B, 1.0, 5, 1.0, 1.0)},
    }


def _tdax(inp: dict) -> dict:
    """tdax's mesh calls on the 8 virtual devices."""
    mesh = j_make_mesh(dp=8, tp=1)
    out = {}
    train = jnp.asarray(inp["train"])
    for name, x in inp["clouds"].items():
        for metric in ("euclidean", "cosine"):
            out[f"knn_{name}_{metric}"] = [np.asarray(a) for a in js.knn_blocked(
                jnp.asarray(x), K, metric, mesh=mesh)]
            out[f"cross_{name}_{metric}"] = [np.asarray(a) for a in js.knn_blocked_cross(
                jnp.asarray(x), train, K, metric, mesh=mesh)]
    lay = inp["layouts"]["tdax"]
    out["layout_tdax"] = np.asarray(js.optimize_layout_edges_sharded(
        jnp.asarray(lay["init"]), jnp.asarray(lay["head"]), jnp.asarray(lay["tail"]),
        jnp.asarray(lay["wgt"]), lay["n"], lay["epochs"], jax.random.PRNGKey(2), A, B, mesh))
    return out


def _one_device(inp: dict) -> dict:
    """The port's one-device counterparts of every mesh call."""
    out = {}
    train = _t(inp["train"])
    for name, x in inp["clouds"].items():
        for metric in ("euclidean", "cosine"):
            out[f"knn_{name}_{metric}"] = [t.numpy() for t in ts.knn_blocked(_t(x), K, metric)]
            out[f"cross_{name}_{metric}"] = [t.numpy() for t in ts.knn_blocked_cross(
                _t(x), train, K, metric)]
    lay = inp["layouts"]["port"]
    out["layout_port"] = ts.optimize_layout_edges(
        _t(lay["init"]), _t(lay["head"], True), _t(lay["tail"], True), _t(lay["wgt"]),
        lay["n"], N_EPOCHS, 2, A, B).numpy()
    for name, ft in inp["fixed_tail"].items():
        out[f"fixed_tail_{name}"] = ts.optimize_layout_edges_fixed_tail(
            _t(ft["init"]), _t(ft["train_emb"]), _t(ft["head"], True), _t(ft["tail"], True),
            _t(ft["wgt"]), ft["epochs"], 3, A, B, initial_alpha=0.25).numpy()
    return out


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    for name in ("eight", "one"):
        (work / name).mkdir()
    eight = worlds.run_world(worlds.umap_world, 8, work / "eight", str(inp_path))
    one = worlds.run_world(worlds.umap_world, 1, work / "one", str(inp_path))[0]
    return {"inp": inp, "tdax": _tdax(inp), "port": _one_device(inp), "eight": eight,
            "one": one}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_umap", _compute)


def _exact(a, b, metric):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if metric == "cosine":
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        return np.clip(1.0 - a @ b.T, 0.0, 2.0)
    return np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))


KNN_CASES = [(kind, cloud, metric) for kind in ("knn", "cross") for cloud in ("n205", "n77")
             for metric in ("euclidean", "cosine")]


@pytest.mark.parametrize("kind,cloud,metric", KNN_CASES)
def test_knn_mesh_is_bitwise_one_device(results, kind, cloud, metric):
    key = f"{kind}_{cloud}_{metric}"
    want = results["port"][key]
    for out in results["eight"] + [results["one"]]:
        got = out[key]
        assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind,cloud,metric", KNN_CASES)
def test_knn_mesh_matches_tdax_mesh(results, kind, cloud, metric):
    key = f"{kind}_{cloud}_{metric}"
    (pi, pd), (ji, jd) = results["eight"][0][key], results["tdax"][key]
    np.testing.assert_allclose(pd, jd, rtol=KNN_TOL, atol=KNN_TOL)
    x = results["inp"]["clouds"][cloud]
    other = x if kind == "knn" else results["inp"]["train"]
    srt = np.sort(_exact(x, other, metric), axis=1)
    clear = srt[:, K] - srt[:, K - 1] > 2 * KNN_TOL
    assert clear.mean() > 0.5
    for r in np.flatnonzero(clear):
        assert set(pi[r]) == set(ji[r]), r
    if kind == "knn":  # self first, at exactly 0, padding or not
        assert (pi[:, 0] == np.arange(len(pi))).all() and (pd[:, 0] == 0).all()


def _pdist(e):
    return np.linalg.norm(e[:, None] - e[None, :], axis=-1).ravel()


def test_layout_mesh_tracks_one_device(results):
    got, want = results["eight"][0]["layout_port"], results["port"]["layout_port"]
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    sil = float(silhouette_score(_t(got), _t(results["inp"]["labels"], True)))
    print(f"8-rank layout: correlation with one device {corr:.6f}, silhouette {sil:.4f}")
    assert corr > LAYOUT_CORR and sil > LAYOUT_SIL
    for out in results["eight"][1:]:  # the ranks stay in lockstep
        np.testing.assert_array_equal(out["layout_port"], got)


def test_layout_mesh_from_tdax_draws_matches_tdax_mesh(results):
    got, want = results["eight"][0]["layout_tdax"], results["tdax"]["layout_tdax"]
    assert np.abs(want).max() > 5.0
    np.testing.assert_allclose(got, want, atol=LAYOUT_TOL)


def test_layout_world_of_one_is_bitwise_one_device(results):
    np.testing.assert_array_equal(results["one"]["layout_port"],
                                  results["port"]["layout_port"])


@pytest.mark.parametrize("name", ["n64", "n53"])
def test_fixed_tail_mesh_is_bitwise_one_device(results, name):
    want = results["port"][f"fixed_tail_{name}"]
    assert want.shape == (int(name[1:]), 2) and np.isfinite(want).all()
    for out in results["eight"] + [results["one"]]:
        np.testing.assert_array_equal(out[f"fixed_tail_{name}"], want)


def test_embed_sparse_mesh_keeps_the_clusters(results):
    got, want = results["eight"][0]["embed"], results["eight"][0]["single"]["embed"]
    assert got.shape == want.shape == (N_TRAIN, 2) and np.isfinite(got).all()
    corr = np.corrcoef(_pdist(got), _pdist(want))[0, 1]
    sil = float(silhouette_score(_t(got), _t(results["inp"]["labels"], True)))
    print(f"8-rank embed_sparse: pdist correlation {corr:.6f}, silhouette {sil:.4f}")
    assert corr > LAYOUT_CORR and sil > LAYOUT_SIL
    for out in results["eight"][1:]:
        np.testing.assert_array_equal(out["embed"], got)


@pytest.mark.parametrize("world", ["eight", "one"])
def test_transform_sparse_mesh_is_bitwise_one_device(results, world):
    ranks = results[world] if world == "eight" else [results[world]]
    for out in ranks:
        assert out["transform"].shape == (len(results["inp"]["embed"]["x_new"]), 2)
        np.testing.assert_array_equal(out["transform"], out["single"]["transform"])


def test_embed_sparse_world_of_one_is_bitwise_one_device(results):
    np.testing.assert_array_equal(results["one"]["embed"], results["one"]["single"]["embed"])


def test_mesh_calls_count_their_collectives(results):
    """Per rank: two gathers a kNN call (16), the layouts' one all_reduce
    an epoch, two fixed-tail gathers, and embed_sparse's and
    transform_sparse's (2 + N_EPOCHS, 2 + 1)."""
    want = {"gloo.all_gather": 16 + 2 + 2 + 3,
            "gloo.all_reduce": 2 * N_EPOCHS + TDAX_DRAW_EPOCHS}
    for out in results["eight"] + [results["one"]]:
        assert out["collectives"] == want
