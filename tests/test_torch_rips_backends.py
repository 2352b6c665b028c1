"""The port's Rips backends beside the native engine against tdax's, on
the CPU: the python oracle, ``rips``'s options and routing, the batched
device reduction (``rips_tiny_batched`` with ``device="cpu"``), and the
sweeps' ``backend`` dispatch.

Tolerances, each as tdax's own tests set it:
  * the oracle is a copy of tdax's: equal diagrams, exactly;
  * oracle against native engine: rtol 1e-9, atol 1e-12 on the same f64
    distances (tests/test_rips.py), and shapes equal;
  * ``rips_tiny_batched`` against the native engine and against tdax's
    ``rips_tiny_batched``: equal shapes (the pairing is the filtration's,
    so the bar counts are exact) and values within 5e-5
    (tests/test_rips_tiny_device.py: f32 distances against the engine's
    f64).  The port sums the squared coordinate differences without
    fused multiply-adds, where XLA's CPU code fuses them, so the two f32
    distance sets may differ in the last bit; where they are bitwise
    equal the Jacobi sweep counts must be tdax's too;
  * the sweeps' stats against tdax's persistence functions on the port's
    own 3-d clouds: rtol 1e-5, atol 1e-6 (tests/test_torch_sweep.py) for
    the host engines; with ``backend="device"`` the 5e-5 above, since a
    persistence is a difference of two f32 distances (at ~28 one ulp is
    1.9e-6) and the two packages' f32 sums may round a distance apart.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.data.adversarial import generate_adversarial_metadata as j_generate_adversarial
from tdax.data.io import save_activations as j_save_activations
from tdax.metrics.persistence import diagram_stats as j_diagram_stats
from tdax.metrics.persistence import get_persistence as j_get_persistence
from tdax.ops.distances import pairwise_distances as j_pairwise_distances
from tdax.ops.distances import pairwise_euclidean_np as j_pairwise_euclidean_np
from tdax.ops.rips import rips as j_rips
from tdax.ops.rips import tiny_device as jt
from tdax.ops.rips.reference import rips_reference as j_rips_reference
from tdax.pipeline.tda_sweep import persistence_per_layer as j_persistence_per_layer

import tdax_torch.ops.rips.native as native
from tdax_torch.config import RipsConfig, SweepConfig, UMAPConfig
from tdax_torch.data.io import load_activations
from tdax_torch.ops import distances
from tdax_torch.ops.rips import rips, rips_from_distances
from tdax_torch.ops.rips import tiny_device as tt
from tdax_torch.ops.rips.reference import enclosing_radius, rips_reference
from tdax_torch.pipeline import scale
from tdax_torch.pipeline.adversarial import run_adversarial_sweep
from tdax_torch.pipeline.tda_sweep import persistence_per_layer, run_tda_sweep

TINY_TOL = 5e-5  # tests/test_rips_tiny_device.py
STATS_ATOL = {"device": TINY_TOL, "python": 1e-6}  # see the docstring


def _same_diagrams(got, want, atol, rtol=0.0):
    assert len(got) == len(want)
    for p, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (p, a.shape, b.shape)
        assert np.array_equal(np.isinf(a), np.isinf(b)), p
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol, err_msg=f"dim {p}")


# --- the python oracle and rips's options ----------------------------------------

@pytest.mark.parametrize("seed,n,maxdim,thresh", [(0, 24, 2, np.inf), (1, 30, 1, np.inf),
                                                  (2, 20, 2, 1.2), (3, 30, 1, 0.8),
                                                  (4, 12, 0, np.inf)])
def test_oracle_equals_tdax_oracle_and_native_engine(seed, n, maxdim, thresh):
    x = np.random.default_rng(seed).normal(size=(n, 3))
    dist = j_pairwise_euclidean_np(x)
    got = rips_reference(dist, maxdim=maxdim, thresh=thresh)
    want = j_rips_reference(dist, maxdim=maxdim, thresh=thresh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    nat = native.rips_native(dist, maxdim=maxdim, thresh=thresh)
    _same_diagrams([np.sort(d, axis=0) for d in got], [np.sort(d, axis=0) for d in nat],
                   atol=1e-12, rtol=1e-9)
    assert enclosing_radius(dist) == float(np.min(np.max(dist, axis=1)))


@pytest.mark.parametrize("backend", ["python", "native", "auto"])
def test_rips_backends_match_tdax(backend):
    x = np.random.default_rng(11).normal(size=(22, 3))
    for kw in ({"maxdim": 2}, {"maxdim": 1, "thresh": 1.0}):
        got = rips(x, backend=backend, **kw)["dgms"]
        want = j_rips(x, backend=backend, **kw)["dgms"]
        _same_diagrams(got, want, atol=1e-12, rtol=1e-9)
        assert all(d.dtype == np.float64 for d in got)


def test_maxdim_4_takes_the_oracle(monkeypatch):
    """tdax's test_maxdim_above_native_cap_routes_to_python, and the
    engine is not called."""
    x = np.random.default_rng(9).normal(size=(9, 3))
    want = j_rips(x, maxdim=4)["dgms"]

    def refuse(*args, **kwargs):
        raise AssertionError("the native engine was called at maxdim 4")
    monkeypatch.setattr(native, "rips_native", refuse)
    got = rips(x, maxdim=4)["dgms"]
    assert len(got) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    with pytest.raises(ValueError):
        rips(x, maxdim=4, backend="native")


@pytest.mark.parametrize("kwargs,error", [({"coeff": 3}, NotImplementedError),
                                          ({"backend": "gpu"}, ValueError),
                                          ({"metric": "manhattan"}, ValueError)])
def test_options_refused_as_tdax(kwargs, error):
    x = np.random.default_rng(0).normal(size=(6, 2))
    with pytest.raises(error):
        j_rips(x, **kwargs)
    with pytest.raises(error):
        rips(x, **kwargs)
    if "metric" not in kwargs:
        with pytest.raises(error):
            rips_from_distances(j_pairwise_euclidean_np(x), **kwargs)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_cosine_metric_matches_tdax(backend):
    x = np.random.default_rng(3).normal(size=(20, 8)) + 0.5
    _same_diagrams(rips(x, maxdim=1, metric="cosine", backend=backend)["dgms"],
                   j_rips(x, maxdim=1, metric="cosine", backend=backend)["dgms"], atol=0)


def test_rips_from_distances_keeps_f32_and_thresholds():
    x = np.random.default_rng(4).normal(size=(25, 3))
    d32 = j_pairwise_euclidean_np(x).astype(np.float32)
    from tdax.ops.rips import rips_from_distances as j_rips_from_distances
    for kw in ({}, {"thresh": 0.9, "maxdim": 2}, {"backend": "python"}):
        _same_diagrams(rips_from_distances(d32, **kw)["dgms"],
                       j_rips_from_distances(d32, **kw)["dgms"], atol=0)


# --- the batched device reduction ---------------------------------------------------

def _cases():
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(6, 3)) * 3
    clustered = np.stack([centers[i // 6] + rng.normal(0, 0.05, 3) for i in range(36)])
    dup = clustered.copy()
    dup[1] = dup[0]  # an exact duplicate point (a zero-length edge)
    # an integer grid: many equal diameters, so the colex tie-break decides
    grid = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0), [0.0]), -1).reshape(-1, 3)[:36]
    theta = np.linspace(0, 2 * np.pi, 13)[:12]
    circle = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)], 1)
    circle += np.random.default_rng(1).normal(0, 0.01, circle.shape)
    return {"random": np.random.default_rng(0).normal(size=(6, 36, 3)),
            "clustered_dup_grid": np.stack([clustered, dup, grid]),
            "circle_small_n": np.stack([circle, np.random.default_rng(1).normal(size=(12, 3))]),
            "n3": np.random.default_rng(2).normal(size=(2, 3, 4))}


@pytest.mark.parametrize("case", list(_cases()))
def test_tiny_batched_matches_tdax_and_native(case):
    clouds = _cases()[case].astype(np.float32)
    n = clouds.shape[1]
    got = tt.rips_tiny_batched(clouds, maxdim=1, device="cpu")
    want = jt.rips_tiny_batched(clouds, maxdim=1)
    assert tt.LAST_RUN["clouds"] == len(clouds) and tt.LAST_RUN["maxdim"] == 1
    for i, cloud in enumerate(clouds):
        _same_diagrams(got[i], want[i], atol=TINY_TOL)
        _same_diagrams(got[i], j_rips(cloud.astype(np.float64), maxdim=1)["dgms"],
                       atol=TINY_TOL)
        _same_diagrams(got[i], rips(cloud.astype(np.float64), maxdim=1)["dgms"], atol=TINY_TOL)
    # the sweeps are tdax's where the f32 distances are
    births, _, _, converged, sweeps = tt._tiny_h1_pairs(torch.from_numpy(clouds), n)
    jb, _, _, jconv, jsweeps = jt._tiny_h1_pairs(jnp.asarray(clouds), n)
    assert converged and bool(jconv) and sweeps == tt.LAST_RUN["h1_sweeps"]
    if np.array_equal(births.numpy(), np.asarray(jb)):
        assert sweeps == int(jsweeps)
    if case == "circle_small_n":  # a noisy circle has one dominant loop
        pers = np.diff(got[0][1], axis=1)[:, 0]
        assert pers.max() > 3 * (np.sort(pers)[-2] if len(pers) > 1 else 0.01)


def test_tiny_batched_integer_grid_sweeps_equal_tdax():
    """Exact distances (integer coordinates): births bitwise tdax's, the
    same sweep count, the same deaths."""
    grid = _cases()["clustered_dup_grid"][2:].astype(np.float32)
    births, deaths, _, _, sweeps = tt._tiny_h1_pairs(torch.from_numpy(grid), 36)
    jb, jd, _, _, jsweeps = jt._tiny_h1_pairs(jnp.asarray(grid), 36)
    np.testing.assert_array_equal(births.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(deaths.numpy(), np.asarray(jd))
    assert sweeps == int(jsweeps) > 1


def _h2_batch():
    rng = np.random.default_rng(0)
    theta = np.arccos(1 - 2 * rng.random(18))
    phi = 2 * np.pi * rng.random(18)
    sphere = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                       np.cos(theta)], 1)
    rand = rng.normal(size=(18, 3))
    dup = rand.copy()
    dup[1] = dup[0]
    grid = np.stack(np.meshgrid(np.arange(3.0), np.arange(3.0), np.arange(2.0)),
                    -1).reshape(-1, 3)
    return np.stack([sphere, rand, dup, grid, rng.normal(size=(18, 3))]).astype(np.float32)


@pytest.mark.parametrize("chunk", [None, "2"])
def test_tiny_batched_h2_matches_tdax_and_native(monkeypatch, chunk):
    """maxdim 2 at n = 18, whole and in chunks of 2 (the tail chunk padded
    with cloud 0), against tdax (the same chunk) and the native engine."""
    if chunk:
        monkeypatch.setenv("TDAX_TINY_H2_CHUNK", chunk)
    else:
        monkeypatch.delenv("TDAX_TINY_H2_CHUNK", raising=False)
    batch = _h2_batch()
    got = tt.rips_tiny_batched(batch, maxdim=2, device="cpu")
    assert tt.LAST_RUN["h2_chunk"] == (2 if chunk else 5)
    assert len(tt.LAST_RUN["h2_sweeps"]) == (3 if chunk else 1)
    want = jt.rips_tiny_batched(batch, maxdim=2)
    for i, cloud in enumerate(batch):
        _same_diagrams(got[i], want[i], atol=TINY_TOL)
        _same_diagrams(got[i], rips(cloud.astype(np.float64), maxdim=2)["dgms"], atol=TINY_TOL)
    assert len(got[0][2]) > 0  # the sphere's void


def test_tiny_batched_limits_and_placement(monkeypatch):
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="n <= 100"):
        tt.rips_tiny_batched(rng.normal(size=(2, 101, 3)), device="cpu")
    with pytest.raises(ValueError, match="n <= 48"):
        tt.rips_tiny_batched(rng.normal(size=(2, 49, 3)), maxdim=2, device="cpu")
    with pytest.raises(ValueError, match="maxdim <= 2"):
        tt.rips_tiny_batched(rng.normal(size=(2, 10, 3)), maxdim=3, device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        tt.rips_tiny_batched(rng.normal(size=(2, 2, 3)), device="cpu")
    x = rng.normal(size=(2, 10, 3)).astype(np.float32)
    # a tensor stays where it lies; an array goes to the card, which is absent here
    assert len(tt.rips_tiny_batched(torch.from_numpy(x))) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.rips_tiny_batched(x)


def test_tiny_batched_raises_when_not_converged(monkeypatch):
    monkeypatch.setattr(tt, "_MAX_SWEEPS", 2)
    clouds = np.random.default_rng(2).normal(size=(2, 20, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="did not converge within 2 sweeps"):
        tt.rips_tiny_batched(clouds, device="cpu")


# --- the sweeps' dispatch -----------------------------------------------------------

def test_persistence_per_layer_backends(monkeypatch):
    """tdax's test_sweep_dispatch_uses_device_path: the device batch against
    the host engine; the python backend per layer; TDAX_NO_DEVICE_PH."""
    clouds = np.random.default_rng(3).normal(size=(4, 30, 3)).astype(np.float32)
    dev = persistence_per_layer(clouds, maxdim=1, backend="device", device="cpu")
    want = j_persistence_per_layer(clouds, maxdim=1, backend="device")
    host = persistence_per_layer(clouds, maxdim=1, backend="auto")
    py = persistence_per_layer(clouds, maxdim=1, backend="python")
    for i in range(4):
        _same_diagrams(dev[i], host[i], atol=TINY_TOL)
        _same_diagrams(dev[i], want[i], atol=TINY_TOL)
        _same_diagrams(py[i], host[i], atol=1e-12, rtol=1e-9)
    # "auto" is the native engine, with or without TDAX_NO_DEVICE_PH; an
    # explicit "device" is the device batch either way, as in tdax

    def refuse(*args, **kwargs):
        raise AssertionError("the device batch was taken")
    monkeypatch.setattr(tt, "rips_tiny_batched", refuse)
    for env in ("0", "1"):
        monkeypatch.setenv("TDAX_NO_DEVICE_PH", env)
        for a, b in zip(persistence_per_layer(clouds, maxdim=1), host):
            _same_diagrams(a, b, atol=0)
    with pytest.raises(AssertionError, match="device batch"):
        persistence_per_layer(clouds, maxdim=1, backend="device", device="cpu")


def test_rips_config_has_tdax_fields():
    from tdax.config import RipsConfig as JRipsConfig
    assert RipsConfig() == RipsConfig(maxdim=1, thresh=float("inf"), coeff=2, backend="auto")
    assert {f: getattr(RipsConfig(), f) for f in ("maxdim", "thresh", "coeff", "backend")} == {
        f: getattr(JRipsConfig(), f) for f in ("maxdim", "thresh", "coeff", "backend")}
    assert SweepConfig(rips=RipsConfig(backend="device")).rips.backend == "device"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_torch_sweep.py's synthetic activations: layer 2 clustered by shape."""
    root = tmp_path_factory.mktemp("rips_backends_sweep")
    metadata = j_generate_dataset(JDatasetConfig(data_dir=str(root / "data")), render=False)
    rng = np.random.default_rng(0)
    keys = sorted({m["shape"] for m in metadata})
    centers = rng.normal(size=(len(keys), 64)) * 5
    acts = rng.normal(size=(4, len(metadata), 64))
    for j, m in enumerate(metadata):
        acts[2, j] = centers[keys.index(m["shape"])] + rng.normal(0, 0.3, 64)
    npz = str(root / "all_activations.npz")
    j_save_activations(npz, acts.astype(np.float32), [m["id"] for m in metadata], metadata)
    return str(root / "data" / "metadata.json"), npz


@pytest.mark.parametrize("backend", ["device", "python"])
def test_run_tda_sweep_backend_matches_tdax(workspace, tmp_path, backend):
    """The sweep with RipsConfig(backend=...) on the CPU: its stats equal
    tdax's persistence_per_layer with the same backend on the port's own
    3-d clouds, and the "auto" sweep's (the same clouds: one seed)."""
    meta_path, npz = workspace
    runs = {}
    for b in (backend, "auto"):
        cfg = SweepConfig(n_layers=4, output_dir=str(tmp_path / b), rips=RipsConfig(backend=b),
                          umap=UMAPConfig(n_epochs=30), save_diagrams=False)
        runs[b] = run_tda_sweep(load_activations(npz), meta_path, cfg, verbose=False,
                                device="cpu")
    got, auto = runs[backend], runs["auto"]
    np.testing.assert_array_equal(got["clouds_3d"], auto["clouds_3d"])
    assert got["peak_layer"] == auto["peak_layer"] == 2
    want = j_persistence_per_layer(got["clouds_3d"], maxdim=1, backend=backend)
    stats = json.loads((tmp_path / backend / "summary_stats.json").read_text())
    for i, s in enumerate(stats):
        for key, v in j_diagram_stats(want[i], layer=i).items():
            np.testing.assert_allclose(s[key], v, rtol=1e-5, atol=STATS_ATOL[backend],
                                       err_msg=key)
        for key in ("n_h1_features", "n_h0_features"):
            assert s[key] == auto["stats"][i][key]
        np.testing.assert_allclose(s["max_h1_persistence"], auto["stats"][i]["max_h1_persistence"],
                                   atol=TINY_TOL)


@pytest.mark.parametrize("backend", ["device", "python"])
def test_adversarial_sweep_backend_matches_tdax(tmp_path, backend):
    """run_adversarial_sweep with RipsConfig(backend=...) on synthetic
    activations of four bases' 80 pairs (4/20/20/36 a condition): each
    condition's H0/H1 stats equal tdax's persistence functions on the
    condition's 3-d clouds, with the same backend ("python"), or with its
    native engine for "device" (tdax's device batch equals that engine
    within the same 5e-5, tests/test_rips_tiny_device.py, and would
    compile once per condition size)."""
    ds = JDatasetConfig(data_dir=str(tmp_path / "data"))
    bound = [m for m in j_generate_dataset(ds, render=False) if m["type"] == "bound"]
    adv = [m for m in j_generate_adversarial(bound, ds, save=False)
           if m["base_id"] in {b["id"] for b in bound[:4]}]
    rng = np.random.default_rng(1)
    capture = {m["id"]: {"metadata": m, "activations": {
        f"layer_{i}": rng.normal(size=16).astype(np.float32) for i in range(3)}} for m in adv}
    out = tmp_path / "port"
    cfg = SweepConfig(n_layers=3, rips=RipsConfig(backend=backend), umap=UMAPConfig(n_epochs=30),
                      save_diagrams=False)
    summary = run_adversarial_sweep(capture, str(out), cfg, verbose=False, device="cpu")
    assert summary["n_samples_per_condition"] == {"matched": 4, "color_mismatch": 20,
                                                  "shape_mismatch": 20, "both_mismatch": 36}
    for condition, stats in summary["condition_stats"].items():
        clouds = np.stack([np.load(out / condition / "point_clouds" / f"layer_{i}_cloud.npy")
                           for i in range(3)])
        want = j_persistence_per_layer(clouds, maxdim=1,
                                       backend="native" if backend == "device" else backend)
        for s, dgms in zip(stats, want):
            h1, max_h1 = j_get_persistence(dgms[1])
            np.testing.assert_allclose([s["n_h1_features"], s["max_h1_persistence"],
                                        s["max_h0_persistence"]],
                                       [len(h1), max_h1, j_get_persistence(dgms[0])[1]],
                                       rtol=1e-5, atol=STATS_ATOL[backend], err_msg=condition)


# --- the two options that came back with this slice ----------------------------------

def test_rips_at_scale_h0_on_device_as_tdax(monkeypatch):
    """h0_on_device=False keeps the engine's dim-0 bars (no Boruvka);
    True replaces them by Boruvka's; maxdim 0 with it runs no engine."""
    x = np.random.default_rng(5).normal(size=(60, 8))
    calls = []
    real = scale.h0_diagram_device
    monkeypatch.setattr(scale, "h0_diagram_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    off = scale.rips_at_scale(x, maxdim=1, device="cpu", h0_on_device=False)
    assert not calls and "h0_s" not in off["timings"]
    on = scale.rips_at_scale(x, maxdim=1, device="cpu")
    assert len(calls) == 1
    dist = scale.distance_matrix(x, "cpu").numpy()
    engine = rips_from_distances(dist, maxdim=1)["dgms"]
    _same_diagrams(off["dgms"], engine, atol=0)
    _same_diagrams(on["dgms"], engine, atol=1e-6)
    zero = scale.rips_at_scale(x, maxdim=0, device="cpu")
    assert len(zero["dgms"]) == 1 and "engine_s" not in zero["timings"]
    zero_off = scale.rips_at_scale(x, maxdim=0, device="cpu", h0_on_device=False)
    _same_diagrams(zero_off["dgms"], engine[:1], atol=0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("shape", [(30, 5), (64, 65536)])
def test_pairwise_distances_matches_tdax(metric, shape):
    """Both backends against tdax's: numpy exactly (at the small shape: the
    difference form holds [n, n, d]); torch (tdax's "jax") in f32, the
    difference form below n * d = 2^22 and the expansion form from it."""
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    if shape[0] * shape[1] < 2**22:
        np.testing.assert_array_equal(distances.pairwise_distances(x, metric, backend="numpy"),
                                      j_pairwise_distances(x, metric, backend="numpy"))
    got = distances.pairwise_distances(x, metric, device="cpu")
    want = j_pairwise_distances(x, metric)
    assert got.dtype == np.float32 and got.shape == (shape[0], shape[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.diag(got).any()
    with pytest.raises(ValueError, match="backend"):
        distances.pairwise_distances(x, metric, backend="jax")
    with pytest.raises(ValueError, match="metric"):
        distances.pairwise_distances(x, "manhattan", device="cpu")
