"""The port's scale path and Rips stages against tdax, on the CPU.

Same numpy inputs from a seed into both packages:

  * sqdist's plain version against tdax's Pallas kernel in interpret
    mode and against ``tdax.ops.distances.pairwise_euclidean``.  Both
    sides are expansion forms that sum in different orders, so the
    tolerance is relative to the cancelled terms:
    |delta| <= 1e-5 * (|x_i|^2 + |x_j|^2);
  * Boruvka H0 against tdax's ``h0_diagram_tpu`` and against the native
    engine's dim-0 bars: identical (the weights are entries of the
    same matrix);
  * Rips bars on identical clouds: identical (same engine, same f64
    difference-form distances);
  * ``rips_at_scale`` on tests/test_scale_ops.py's two-cluster cloud
    against tdax's: bars within 1e-5 relative (expansion-form
    distances from two matrix products).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdax.metrics.persistence import bottleneck_distance as j_bottleneck
from tdax.ops import distances as jd
from tdax.ops.distances import pairwise_euclidean as j_pairwise_euclidean
from tdax.ops.distances import pairwise_euclidean_np as j_pairwise_euclidean_np
from tdax.ops.pallas_distances import pairwise_euclidean_pallas as j_euclidean_pallas
from tdax.ops.pallas_distances import pairwise_sq_euclidean_pallas as j_sq_pallas
from tdax.ops.rips import rips as j_rips
from tdax.ops.rips.mst import boruvka_mst_weights as j_boruvka
from tdax.ops.rips.mst import h0_diagram_tpu as j_h0
from tdax.pipeline.scale import rips_at_scale as j_rips_at_scale

from tdax_torch.metrics.persistence import bottleneck_distance
from tdax_torch.ops import sqdist
from tdax_torch.ops import distances as td
from tdax_torch.ops.distances import pairwise_euclidean_np
from tdax_torch.ops.rips import rips, rips_from_distances
from tdax_torch.ops.rips.mst import boruvka_mst_weights, h0_diagram_device
from tdax_torch.pipeline.scale import distance_matrix, rips_at_scale

SHAPES = [(36, 3), (100, 17), (130, 257), (40, 4096)]


def _scale_tol(x: np.ndarray) -> np.ndarray:
    sq = (x.astype(np.float64) ** 2).sum(1)
    return 1e-5 * (sq[:, None] + sq[None, :])


@pytest.mark.parametrize("n,d", SHAPES)
def test_sqdist_plain_matches_pallas_interpret(n, d):
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(j_sq_pallas(jnp.asarray(x), interpret=True))
    got = sqdist.sqdist(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    assert (np.abs(got - ref) <= _scale_tol(x)).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("n,d", SHAPES)
def test_sqdist_euclidean_matches_tdax(n, d):
    x = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    got = sqdist.euclidean(torch.as_tensor(x)).numpy()
    ref = np.asarray(j_pairwise_euclidean(jnp.asarray(x)))
    ref_pallas = np.asarray(j_euclidean_pallas(jnp.asarray(x), interpret=True))
    exact = pairwise_euclidean_np(x)
    assert (np.diag(got) == 0).all()
    # |sqrt(a) - sqrt(b)| <= |a - b| / (sqrt(a) + sqrt(b)); compare squares
    for other in (ref, ref_pallas, exact):
        assert (np.abs(got.astype(np.float64) ** 2 - other.astype(np.float64) ** 2)
                <= _scale_tol(x)).all()


@pytest.mark.parametrize("n,d", SHAPES[:3])
def test_distances_match_tdax(n, d):
    """The numpy exact paths are tdax's; the torch difference form, the
    expansion form and the cosine distance agree with tdax's jnp paths
    (cancellation-relative for the expansion form, 1e-6 otherwise)."""
    x = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    np.testing.assert_array_equal(td.pairwise_euclidean_np(x), jd.pairwise_euclidean_np(x))
    np.testing.assert_array_equal(td.pairwise_cosine_np(x), jd.pairwise_cosine_np(x))
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(td.pairwise_euclidean(xt, exact=True).numpy(),
                               np.asarray(jd.pairwise_euclidean(xj, exact=True)),
                               rtol=1e-6, atol=1e-6)
    sq_diff = (td.pairwise_sq_euclidean(xt).double().numpy()
               - np.asarray(jd.pairwise_sq_euclidean(xj)).astype(np.float64))
    assert (np.abs(sq_diff) <= _scale_tol(x)).all()
    np.testing.assert_allclose(td.pairwise_cosine(xt).numpy(),
                               np.asarray(jd.pairwise_cosine(xj)), atol=1e-6)
    assert (torch.diagonal(td.pairwise_euclidean(xt)) == 0).all()


def test_sqdist_dispatch_takes_the_plain_version_on_cpu():
    x = torch.randn(20, 7)
    before = sqdist.LAUNCHES
    torch.testing.assert_close(sqdist.sqdist(x),
                               sqdist.pairwise_sq_euclidean_plain(x), rtol=0, atol=0)
    assert sqdist.LAUNCHES == before


def test_sqdist_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros(4, 4))
    with pytest.raises(TypeError, match="float32"):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros(4, 4, dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_boruvka_matches_tdax(seed):
    x = np.random.default_rng(seed).normal(size=(50, 4))
    dist = j_pairwise_euclidean_np(x).astype(np.float32)
    np.testing.assert_array_equal(boruvka_mst_weights(dist, device="cpu"), j_boruvka(dist))
    np.testing.assert_array_equal(h0_diagram_device(dist, device="cpu"), j_h0(dist))


@pytest.mark.parametrize("thresh", [2.0, np.inf])
def test_boruvka_disconnected_and_duplicates_match_tdax(thresh):
    x = np.array([[0, 0], [1, 0], [10, 0], [11, 0], [11, 0], [0.5, 0.2]], float)
    dist = j_pairwise_euclidean_np(x).astype(np.float32)
    got = h0_diagram_device(dist, thresh, device="cpu")
    np.testing.assert_array_equal(got, j_h0(dist, thresh))
    assert np.isinf(got[:, 1]).sum() == (2 if thresh == 2.0 else 1)


def test_boruvka_equals_engine_h0_on_the_same_matrix():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(200, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    x = (z @ rng.normal(size=(4, 64))).astype(np.float32)
    dist = distance_matrix(x, device="cpu")
    host = dist.numpy()
    thresh = float(np.float32(np.median(np.partition(host, 20, axis=1)[:, 20])))
    engine = rips_from_distances(host, maxdim=0, thresh=thresh)["dgms"][0]
    mst = h0_diagram_device(dist, thresh)
    np.testing.assert_array_equal(np.sort(mst[np.isfinite(mst[:, 1]), 1]),
                                  np.sort(engine[np.isfinite(engine[:, 1]), 1]))
    assert np.isinf(mst[:, 1]).sum() == np.isinf(engine[:, 1]).sum()


@pytest.mark.parametrize("maxdim", [1, 2])
def test_rips_bars_identical_to_tdax(maxdim):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(36, 3))
    got, ref = rips(x, maxdim=maxdim)["dgms"], j_rips(x, maxdim=maxdim)["dgms"]
    assert len(got) == len(ref) == maxdim + 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_rips_from_distances_keeps_f32_and_thresh():
    x = np.random.default_rng(5).normal(size=(30, 3))
    d32 = pairwise_euclidean_np(x).astype(np.float32)
    a = rips_from_distances(d32, maxdim=1, thresh=1.0)["dgms"]
    b = rips_from_distances(d32.astype(np.float64), maxdim=1, thresh=1.0)["dgms"]
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
    with pytest.raises(NotImplementedError, match="maxdim 3"):
        rips_from_distances(d32, maxdim=4)


def test_native_engine_library_name_depends_on_the_host(monkeypatch):
    """A library built for another CPU's instruction set (or by another
    g++) has another name, so it is rebuilt rather than loaded."""
    from tdax_torch.ops.rips import native
    assert b"-march=" in native._host_key()
    names = []
    for key in (b"host a", b"host b"):
        native._target.cache_clear()
        monkeypatch.setattr(native, "_host_key", lambda key=key: key)
        names.append(native._target().name)
    native._target.cache_clear()
    assert names[0] != names[1]
    assert all(n.startswith("libtdax_rips_") and n.endswith(".so") for n in names)


def _two_clusters():
    rng = np.random.default_rng(5)  # tests/test_scale_ops.py:78-95
    return np.concatenate([rng.normal(0, 0.5, (30, 8)),
                           rng.normal(4, 0.5, (30, 8))]).astype(np.float32)


def test_rips_at_scale_matches_tdax():
    x = _two_clusters()
    out = rips_at_scale(x, maxdim=1, thresh=2.5, device="cpu")
    ref = j_rips_at_scale(x, maxdim=1, thresh=2.5)["dgms"]
    assert set(out["timings"]) == {"distance_s", "h0_s", "to_host_s", "engine_s"}
    for got, want in zip(out["dgms"], ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.sort(got, axis=0), np.sort(want, axis=0), rtol=1e-5)
        assert bottleneck_distance(got, want) <= 1e-5
    assert np.isinf(out["dgms"][0][:, 1]).sum() == 2


def test_rips_at_scale_h0_only_and_engine_h0():
    x = _two_clusters()
    h0_only = rips_at_scale(x, maxdim=0, thresh=2.5, device="cpu")["dgms"]
    host = distance_matrix(x, device="cpu").numpy()
    engine = rips_from_distances(host, maxdim=0, thresh=2.5)["dgms"]
    assert len(h0_only) == len(engine) == 1
    np.testing.assert_array_equal(np.sort(h0_only[0][:, 1]), np.sort(engine[0][:, 1]))


def test_distance_matrix_is_symmetric_with_zero_diagonal():
    x = np.random.default_rng(6).normal(size=(70, 33)).astype(np.float32)
    d = distance_matrix(torch.as_tensor(x), device="cpu")
    assert d.dtype == torch.float32
    assert torch.equal(d, d.T)
    assert (torch.diagonal(d) == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_bottleneck_matches_tdax(seed):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.random((12, 2)), axis=1)
    b = np.sort(rng.random((9, 2)), axis=1)
    a[0, 1] = b[0, 1] = np.inf
    assert bottleneck_distance(a, b) == j_bottleneck(a, b)
    assert bottleneck_distance(a, a) == 0.0
    with pytest.raises(NotImplementedError, match="sparse"):
        bottleneck_distance(np.zeros((2049, 2)), np.zeros((0, 2)))
