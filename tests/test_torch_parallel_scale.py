"""The port's multi-device sweep and scale stages against tdax's, on the CPU.

tdax runs its sharded ``jit`` on the conftest's 8 virtual XLA devices;
the port runs gloo worlds of CPU processes (``torch_parallel_worlds``):
a world of 8, one of 4 and one of 1, each spawned once per test session.
The numpy inputs come from seeds.  The stages are those of
``__graft_entry__.py``'s multi-device dry run, at its shapes and gates:

  3. at dp=2 tp=4, 64 points in 16-d, k = 6: ``sharded_knn`` (both
     metrics) row by row exact or explained by a tie within 1e-5, its
     distances the k smallest within 1e-5 and ascending;
     ``sharded_pairwise_sq_euclidean``'s blocks reassembled within
     1e-5 (|x_i|^2 + |x_j|^2) of tdax's; ``rips_at_scale(mesh=)`` within
     1e-4 of f64 ``rips`` and of tdax's mesh call;
     ``rips_at_scale_sparse(mesh=)`` on the blocked branch with tdax's
     and the port's one-device ``n_edges`` and diagrams within 1e-5 of
     both.  At dp=8, a cloud the axis pads: ``sharded_edge_extract``'s
     columns, counts and truncation count equal to tdax's, at a
     threshold that keeps and at one that truncates (padded rows are not
     counted);
  2. both batched UMAP modes on an [8, 24, 12] stack, one layer a rank:
     bitwise the port's one-device result, and from tdax's spectral init
     (injected as tests/test_torch_sweep.py does) each layer's pairwise
     distances correlated > 0.995 with tdax's sharded result.

``run_tda_sweep`` in the world of 4 (one layer a rank) writes the files
of the world of one from rank 0 alone; every rank returns the whole
result.  In a world of one every path is bitwise its one-device
counterpart, with the gathers run and counted.
"""

import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.config import UMAPConfig as JUMAPConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.data.io import save_activations as j_save_activations
from tdax.ops.rips import rips as j_rips
from tdax.ops.umap import fuzzy as jf
from tdax.ops.umap.spectral import spectral_init as j_spectral_init
from tdax.ops.umap.umap import fit_transform_batched as j_fit_transform_batched
from tdax.ops.umap.umap import shared_transform_batched as j_shared_transform_batched
from tdax.parallel import make_mesh as j_make_mesh
from tdax.parallel.sharded_ops import sharded_edge_extract as j_sharded_edge_extract
from tdax.parallel.sharded_ops import sharded_knn as j_sharded_knn
from tdax.parallel.sharded_ops import sharded_pairwise_sq_euclidean as j_sharded_sq
from tdax.pipeline.scale import rips_at_scale as j_rips_at_scale
from tdax.pipeline.scale import rips_at_scale_sparse as j_rips_at_scale_sparse

import torch_parallel_worlds as worlds
from tdax_torch.config import UMAPConfig
from tdax_torch.ops.umap.umap import fit_transform_batched, shared_transform_batched
from tdax_torch.parallel.sharded_ops import sharded_pairwise_sq_euclidean
from tdax_torch.pipeline.scale import rips_at_scale_sparse

N, D, K = 64, 16, 6                          # the dry run's stage 3 (dp * 32 points)
N_PAD, BUDGET, CHUNK = 50, 12, 2048          # c = 50 // 8 = 6: padded to 96 rows at dp=8
UMAP_KW = dict(n_neighbors=6, n_components=3, n_epochs=50)   # the dry run's stage 2
N_LAYERS, HIDDEN, SWEEP_EPOCHS = 4, 64, 30   # the tiny capture's depth and width
KNN_TOL = 1e-5      # tdax's: a disputed neighbour's distance within 1e-5 of the others
RIPS_TOL = 1e-4     # tdax's rips_at_scale(mesh) against f64 rips
SPARSE_TOL = 1e-5   # tdax's sparse mesh extraction against one device
UMAP_CORR = 0.995   # tdax's pairwise-distance correlation of the sharded UMAP


def _gap_threshold(x: np.ndarray, q: float) -> float:
    """A threshold near the q-quantile of x's pairwise distances, midway in
    a gap of at least 1e-3 between two of them, so that f32 rounding in
    either package cannot move an edge across it."""
    d = np.sqrt(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1))
    v = np.unique(d[np.triu_indices(len(x), 1)])
    i = int(q * len(v))
    while v[i + 1] - v[i] < 1e-3:
        i += 1
    return float((v[i] + v[i + 1]) / 2)


def _inputs(work) -> dict:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x_pad = rng.normal(size=(N_PAD, D)).astype(np.float32)
    clouds = rng.normal(size=(8, 24, 12)).astype(np.float32)
    # the tiny capture: tests/test_torch_sweep.py's synthetic activations
    metadata = j_generate_dataset(JDatasetConfig(data_dir=str(work / "data")), render=False)
    keys = sorted({m["shape"] for m in metadata})
    centers = rng.normal(size=(len(keys), HIDDEN)) * 5
    acts = rng.normal(size=(N_LAYERS, len(metadata), HIDDEN))
    for j, m in enumerate(metadata):
        acts[2, j] = centers[keys.index(m["shape"])] + rng.normal(0, 0.3, HIDDEN)
    npz = str(work / "all_activations.npz")
    j_save_activations(npz, acts.astype(np.float32), [m["id"] for m in metadata], metadata)
    # tdax's spectral inits (Threefry jitter included) for the stack's fits
    k_init, _ = jax.random.split(jax.random.PRNGKey(JUMAPConfig().random_state))
    inits = [np.asarray(j_spectral_init(jf.fuzzy_simplicial_set(jnp.asarray(c), 6, "cosine")[0],
                                        3, k_init)) for c in clouds]
    return {"x": x, "k": K, "x_pad": x_pad, "budget": BUDGET, "chunk": CHUNK,
            "thresholds": {"keeps": _gap_threshold(x_pad, 0.05),
                           "truncates": _gap_threshold(x_pad, 0.5)},
            "clouds": clouds, "undivided": np.concatenate([clouds, clouds[:4]]),
            "umap": UMAP_KW, "tdax_init": np.stack(inits), "tdax_init_shared": inits[-1],
            "npz": npz, "metadata_path": str(work / "data" / "metadata.json"),
            "n_layers": N_LAYERS, "n_epochs": SWEEP_EPOCHS}


def _tdax(inp: dict) -> dict:
    """tdax's sharded results on the 8 virtual devices."""
    x, mesh = inp["x"], j_make_mesh(dp=2, tp=4)
    out = {f"knn_{m}": tuple(np.asarray(a) for a in j_sharded_knn(jnp.asarray(x), K, mesh,
                                                                   metric=m))
           for m in ("euclidean", "cosine")}
    out["sq"] = np.asarray(j_sharded_sq(jnp.asarray(x), mesh))
    out["rips"] = j_rips_at_scale(x, maxdim=1, mesh=mesh)["dgms"]
    out["rips_f64"] = j_rips(x.astype(np.float64), maxdim=1)["dgms"]
    sp = j_rips_at_scale_sparse(x, maxdim=1, target_degree=12, fused_max=0, block_rows=N,
                                mesh=mesh)
    out["sparse"] = {"n_edges": sp["n_edges"], "dgms": sp["dgms"]}
    mesh8 = j_make_mesh(dp=8)
    out["edges"] = {name: j_sharded_edge_extract(jnp.asarray(inp["x_pad"]), t, BUDGET, mesh8,
                                                 chunk=CHUNK)
                    for name, t in inp["thresholds"].items()}
    ucfg = JUMAPConfig(**UMAP_KW)
    out["fit"] = j_fit_transform_batched(inp["clouds"], ucfg)
    out["shared"] = j_shared_transform_batched(inp["clouds"], ucfg)
    return out


def _compute(work) -> dict:
    inp = _inputs(work)
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    for name in ("scale", "sweep", "one"):
        (work / name).mkdir()
    scale = worlds.run_world(worlds.scale_world, 8, work / "scale", str(inp_path))
    sweep = worlds.run_world(worlds.sweep_world, 4, work / "sweep", str(inp_path),
                             str(work / "sweep" / "out"))
    one = worlds.run_world(worlds.one_scale_world, 1, work / "one", str(inp_path),
                           str(work / "one"))[0]
    ucfg = UMAPConfig(**UMAP_KW)
    sp = rips_at_scale_sparse(inp["x"], maxdim=1, target_degree=12, fused_max=0, block_rows=N,
                              device="cpu")
    port = {"fit": fit_transform_batched(inp["clouds"], ucfg, device="cpu"),
            "shared": shared_transform_batched(inp["clouds"], ucfg, device="cpu"),
            "undivided": fit_transform_batched(inp["undivided"], ucfg, device="cpu"),
            "sparse": {"n_edges": sp["n_edges"], "dgms": sp["dgms"]}}
    files = {p.relative_to(work / "sweep" / "out").as_posix(): p.read_bytes()
             for p in sorted((work / "sweep" / "out").rglob("*")) if p.is_file()}
    one_files = {p.relative_to(work / "one" / "grouped").as_posix(): p.read_bytes()
                 for p in sorted((work / "one" / "grouped").rglob("*")) if p.is_file()}
    return {"inp": inp, "tdax": _tdax(inp), "port": port, "scale": scale, "sweep": sweep,
            "sweep_files": files, "one_files": one_files, "one": one}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_scale", _compute)


def _expansion_f32(x: np.ndarray, metric: str) -> np.ndarray:
    """The dry run's reference: the same f32 arithmetic in numpy."""
    if metric == "cosine":
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        return np.clip(1.0 - xn @ xn.T, 0.0, 2.0).astype(np.float32)
    sq = np.sum(x * x, axis=1)
    return np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)).astype(
        np.float32)


def _check_knn(idx, dists, ref_idx, d) -> int:
    """tdax's stage-3 gate; returns the rows that differ from ref_idx."""
    assert np.all(np.diff(dists, axis=1) >= 0), "distances not ascending"
    mismatched = 0
    for i in range(len(idx)):
        got, want = set(idx[i].tolist()), set(ref_idx[i].tolist())
        if got == want:
            continue
        mismatched += 1
        disputed = d[i, sorted(got ^ want)]
        assert disputed.max() - disputed.min() <= KNN_TOL * max(1.0, disputed.max()), (
            f"row {i}: neighbour set differs beyond f32 ties: {sorted(got)} vs {sorted(want)}")
        np.testing.assert_allclose(dists[i], np.sort(d[i])[:K], atol=KNN_TOL)
    return mismatched


def _same_dgms(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        np.testing.assert_allclose(g[finite], w[finite], rtol=tol, atol=tol)


# ---- stage 3: the row-sharded scale kernels ------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_knn_matches_tdax(results, metric):
    x = results["inp"]["x"]
    d = _expansion_f32(x, metric)
    col = np.arange(N)
    ref_idx = np.stack([col[np.lexsort((col, d[i]))[:K]] for i in range(N)])
    idx, dists = results["scale"][0]["stage3"][f"knn_{metric}"]
    assert idx.shape == dists.shape == (N, K) and idx.dtype == np.int32
    print(f"{metric}: rows differing from the f32 reference "
          f"{_check_knn(idx, dists, ref_idx, d)}, from tdax's "
          f"{_check_knn(idx, dists, results['tdax'][f'knn_{metric}'][0], d)}")
    for out in results["scale"][1:]:  # every rank holds every row
        np.testing.assert_array_equal(out["stage3"][f"knn_{metric}"][0], idx)


def test_sharded_pairwise_blocks_reassemble_tdax(results):
    x = results["inp"]["x"].astype(np.float64)
    ranks = results["scale"]
    by_dp = {}
    for out in ranks:  # the tp ranks of a dp index hold the same block
        block = out["stage3"]["sq_block"]
        assert block.shape == (N // 2, N)
        by_dp.setdefault(out["dp_rank"], block)
        np.testing.assert_array_equal(block, by_dp[out["dp_rank"]])
    got = np.concatenate([by_dp[r] for r in range(2)])
    sq = (x * x).sum(1)
    bound = KNN_TOL * (sq[:, None] + sq[None, :])
    assert np.all(np.abs(got - results["tdax"]["sq"]) <= bound)
    assert np.all(got >= 0)


@pytest.mark.parametrize("ref", ["rips_f64", "rips"])
def test_rips_at_scale_mesh_matches(results, ref):
    _same_dgms(results["scale"][0]["stage3"]["rips"], results["tdax"][ref], RIPS_TOL)


@pytest.mark.parametrize("ref", ["tdax", "port"])
def test_sparse_mesh_extraction_matches(results, ref):
    got, want = results["scale"][0]["stage3"]["sparse"], results[ref]["sparse"]
    assert got["n_edges"] == want["n_edges"] > 0
    _same_dgms(got["dgms"], want["dgms"], SPARSE_TOL)


def test_scale_results_equal_on_every_rank(results):
    first = results["scale"][0]["stage3"]
    for out in results["scale"][1:]:
        for key in ("rips", "sparse"):
            got, want = out["stage3"][key], first[key]
            got, want = (got["dgms"], want["dgms"]) if key == "sparse" else (got, want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["keeps", "truncates"])
def test_edge_extract_padded_matches_tdax(results, case):
    cols, counts, n_trunc = results["scale"][0]["edges"][case]
    want = results["tdax"]["edges"][case]
    assert cols.shape == (N_PAD, BUDGET) and cols.dtype == counts.dtype == np.int32
    np.testing.assert_array_equal(cols, want[0])
    np.testing.assert_array_equal(counts, want[1])
    assert n_trunc == want[2]
    # truncated: the real rows whose BUDGET-th smallest f64 distance is
    # within the threshold (96 rows computed, 50 of them real)
    x = results["inp"]["x_pad"].astype(np.float64)
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    t = results["inp"]["thresholds"][case]
    expected = int((np.sort(d, axis=1)[:, BUDGET - 1] <= t).sum())
    assert n_trunc == expected
    assert (n_trunc > 0) == (case == "truncates")
    np.testing.assert_array_equal(counts, np.minimum((d <= t).sum(1), BUDGET))


class _Axis:
    """A mesh axis of 3 ranks, this rank the first: all the block needs."""
    shape = {"dp": 3}

    def local_rank(self, axis):
        return 0


def test_sharded_pairwise_refuses_an_undivided_axis():
    import torch
    with pytest.raises(ValueError, match="64 rows do not divide over the 3 ranks"):
        sharded_pairwise_sq_euclidean(torch.zeros(N, D), _Axis())


# ---- stage 2: the layer axis over the ranks ------------------------------

@pytest.mark.parametrize("mode", ["fit", "shared"])
def test_stage2_equals_the_port_on_one_device(results, mode):
    for out in results["scale"]:
        got = out["stage2"][mode]
        assert got.shape == (8, 24, 3) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, results["port"][mode])


def _pdist(e):
    return np.linalg.norm(e[:, None] - e[None, :], axis=-1).ravel()


@pytest.mark.parametrize("mode", ["fit", "shared"])
def test_stage2_from_tdax_init_matches_tdax_sharded(results, mode):
    got, want = results["scale"][0]["stage2"][f"{mode}_tdax_init"], results["tdax"][mode]
    corr = [np.corrcoef(_pdist(g), _pdist(w))[0, 1] for g, w in zip(got, want)]
    print(f"stage 2 {mode}: pdist correlation per layer {np.round(corr, 5).tolist()}")
    assert min(corr) > UMAP_CORR


def test_undivided_layer_axis_runs_whole_on_every_rank(results):
    for out in results["scale"]:
        assert out["stage2"]["undivided_gathers"] == 0
        np.testing.assert_array_equal(out["stage2"]["undivided"], results["port"]["undivided"])


# ---- the sweep over four ranks -------------------------------------------

def test_sweep_world_equals_the_world_of_one(results):
    one = results["one"]["grouped"]["sweep"]
    for out in results["sweep"]:
        assert out["peak_layer"] == one["peak_layer"] == 2
        assert out["stats"] == one["stats"]
        np.testing.assert_array_equal(out["clouds_3d"], one["clouds_3d"])
    stats = json.loads(results["sweep_files"]["summary_stats.json"])
    assert stats == one["stats"]
    assert results["sweep_files"] == results["one_files"]


def test_sweep_files_written_by_rank_zero_alone(results):
    writes = [out["writes"] for out in results["sweep"]]
    assert writes[0].count("np.save") == N_LAYERS and "dump_json" in writes[0]
    assert writes[1:] == [[], [], []]
    assert sorted(results["sweep_files"]) == sorted(
        ["summary_stats.json"] + [f"point_clouds_3d/layer_{i}_cloud.npy" for i in range(N_LAYERS)])


def test_sweep_gathers_the_layers_once(results):
    for out in results["sweep"]:
        assert out["collectives"] == {"gloo.all_gather": 1}


# ---- the world of one ----------------------------------------------------

@pytest.mark.parametrize("path", ["fit", "shared", "dense"])
def test_world_of_one_is_bitwise_one_device(results, path):
    one = results["one"]
    np.testing.assert_array_equal(one["grouped"][path], one["single"][path])


def test_world_of_one_sweep_and_sparse_are_bitwise(results):
    g, s = results["one"]["grouped"], results["one"]["single"]
    assert g["sweep"]["stats"] == s["sweep"]["stats"]
    np.testing.assert_array_equal(g["sweep"]["clouds_3d"], s["sweep"]["clouds_3d"])
    assert g["sparse"]["n_edges"] == s["sparse"]["n_edges"]
    for a, b in zip(g["sparse"]["dgms"], s["sparse"]["dgms"]):
        np.testing.assert_array_equal(a, b)


def test_world_of_one_runs_and_counts_the_collectives(results):
    # the sweep's, fit's, shared's and the matrix's layer or row gathers,
    # the sparse extraction's gather and its result's broadcast
    assert results["one"]["collectives"] == {"gloo.all_gather": 5,
                                             "gloo.broadcast_object": 1}
