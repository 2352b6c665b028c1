"""The port's geometry metrics and Wasserstein distance against tdax's,
on the CPU, on tdax's own fixtures (tests/test_metrics.py) and their
edge cases.

Tolerances: rtol 1e-4 for the effective dimensionality (one f32 SVD on
each side, LAPACK against XLA) and for the matrix entropy (one f32
eigvalsh); rtol 1e-3 for TwoNN (mu is a ratio of nearest-neighbour
distances summed in another order, and the regression over log mu
amplifies that); accuracy exactly; Wasserstein 1e-12 (the same float64
host code on both sides).  NaN must fall in the same places.
"""

import numpy as np
import pytest
import torch

from tdax.metrics import wasserstein_distance as j_wasserstein
from tdax.metrics.geometry import compute_accuracy_by_example as j_accuracy
from tdax.metrics.geometry import compute_effective_dimensionality as j_ed
from tdax.metrics.geometry import compute_fixed_window_ed as j_window_ed
from tdax.metrics.geometry import compute_fixed_window_id as j_window_id
from tdax.metrics.geometry import compute_intrinsic_dimensionality as j_twonn
from tdax.metrics.geometry import matrix_entropy as j_entropy

from tdax_torch.metrics import geometry as g
from tdax_torch.metrics import wasserstein_distance

ED_RTOL, ID_RTOL, ENTROPY_RTOL, WASSERSTEIN_TOL = 1e-4, 1e-3, 1e-4, 1e-12


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32, (got.shape, want.shape, got.dtype)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=rtol, atol=atol)


def _manifold(seed=2, batch=3, n=200, latent=5, d=32):
    """tests/test_metrics.py's TwoNN fixture: a ~latent-d manifold in d dims."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, n, latent))
    emb = rng.normal(size=(latent, d))
    return (z @ emb + rng.normal(0, 1e-3, (batch, n, d))).astype(np.float32)


# --- effective dimensionality ---------------------------------------------------

def test_effective_dimensionality_matches_tdax():
    x = np.random.default_rng(0).normal(size=(4, 20, 32)).astype(np.float32)
    _close(g.compute_effective_dimensionality(x, device="cpu"), j_ed(x), ED_RTOL)


def test_effective_dimensionality_of_orthonormal_rows_is_one():
    x = np.eye(16, 32)[None].astype(np.float32)
    got = g.compute_effective_dimensionality(x, device="cpu")
    assert float(got[0]) == pytest.approx(1.0, abs=1e-5)
    _close(got, j_ed(x), ED_RTOL)


def test_tensor_input_stays_on_its_device():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 10, 8)), dtype=torch.float64)
    got = g.compute_effective_dimensionality(x)
    assert got.device == x.device and got.dtype == torch.float32


@pytest.mark.parametrize("n_windows", [1, 3, 4, 50])
def test_fixed_window_ed_matches_tdax(n_windows):
    x = np.random.default_rng(1).normal(size=(2, 40, 16)).astype(np.float32)
    got = g.compute_fixed_window_ed(x, n_windows, device="cpu")
    assert got.shape == (2, min(n_windows, 40))
    _close(got, j_window_ed(x, n_windows), ED_RTOL)


@pytest.mark.parametrize("n_windows", [0, -2])
def test_fixed_window_ed_refuses_no_windows(n_windows):
    x = np.zeros((1, 8, 4), np.float32)
    with pytest.raises(ValueError, match="n_windows must be positive"):
        g.compute_fixed_window_ed(x, n_windows, device="cpu")
    with pytest.raises(ValueError, match="n_windows must be positive"):
        j_window_ed(x, n_windows)


def test_fixed_window_ed_window_order():
    """Window w of sample b is tokens [w * size, (w + 1) * size) of b."""
    x = np.random.default_rng(7).normal(size=(3, 23, 6)).astype(np.float32)
    got = np.asarray(g.compute_fixed_window_ed(x, 4, device="cpu"))
    for b in range(3):
        for w in range(4):
            one = g.compute_effective_dimensionality(x[b:b + 1, 5 * w:5 * w + 5], device="cpu")
            assert got[b, w] == pytest.approx(float(one[0]), rel=1e-6)


# --- TwoNN ------------------------------------------------------------------------

def test_intrinsic_dimensionality_matches_tdax():
    x = _manifold()
    got = g.compute_intrinsic_dimensionality(x, device="cpu")
    _close(got, j_twonn(x), ID_RTOL)
    assert 3.0 < float(got[0]) < 8.0  # a sane TwoNN estimate for a 5-d manifold


@pytest.mark.parametrize("n", [0, 1, 4, 5])
def test_intrinsic_dimensionality_too_few_samples(n):
    x = np.random.default_rng(0).normal(size=(2, n, 8)).astype(np.float32)
    got = g.compute_intrinsic_dimensionality(x, device="cpu")
    assert got.shape == (2,) and torch.isnan(got).all()
    _close(got, j_twonn(x), ID_RTOL)


@pytest.mark.parametrize("n", [6, 10, 11, 37])
def test_intrinsic_dimensionality_keep_count_at_small_n(n):
    """The keep count int32(n_valid * 0.9) in float32, as tdax: 9 at n = 10,
    where float32 0.9 multiplied in float64 gives 8, which moves the slope."""
    x = _manifold(seed=n, batch=4, n=n, latent=3, d=12)
    _close(g.compute_intrinsic_dimensionality(x, device="cpu"), j_twonn(x), ID_RTOL)


@pytest.mark.parametrize("discard", [0.05, 0.25, 0.5])
def test_intrinsic_dimensionality_discard_fraction(discard):
    x = _manifold(seed=9, batch=2, n=80)
    _close(g.compute_intrinsic_dimensionality(x, discard, device="cpu"), j_twonn(x, discard),
           ID_RTOL)


def _twonn_f64(x, discard, eps=1e-10):
    """TwoNN in float64 numpy, the formula without a compiler between."""
    out = []
    for c in x.astype(np.float64):
        n = len(c)
        d = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        r = np.sort(d, axis=1)[:, :2]
        mu = np.sort(r[:, 1] / r[:, 0])
        k = max(int(np.float32(n) * np.float32(1 - discard)), 5)
        xr = np.log(mu[:k] + eps)
        yr = -np.log(1.0 - np.arange(1, k + 1) / n + eps)
        out.append((xr * yr).sum() / (xr * xr).sum())
    return np.array(out)


def test_intrinsic_dimensionality_keeping_every_ratio():
    """discard_fraction 0 keeps the last ratio, where F = 1 and
    -log(1 - F + eps) = -log(eps): finite.  (tdax under XLA's CPU
    compiler gives NaN there: 1 - (slot + 1) / n is contracted into one
    fused multiply-add with the reciprocal of n, which makes it -1.5e-8.)"""
    x = _manifold(seed=9, batch=2, n=80)
    got = np.asarray(g.compute_intrinsic_dimensionality(x, 0.0, device="cpu"))
    np.testing.assert_allclose(got, _twonn_f64(x, 0.0), rtol=ID_RTOL)
    np.testing.assert_allclose(np.asarray(g.compute_intrinsic_dimensionality(x, device="cpu")),
                               _twonn_f64(x, 0.1), rtol=ID_RTOL)


def test_intrinsic_dimensionality_duplicate_points():
    """Duplicated rows have r1 = 0: they leave mu and n_valid; a cloud
    made only of duplicates is NaN."""
    x = _manifold(seed=4, batch=3, n=40)
    x[0, 20:30] = x[0, :10]        # ten points duplicated
    x[1, 1:] = x[1, :1]            # one point, forty times
    x[2, ::2] = x[2, 1::2]         # every point twice
    got = g.compute_intrinsic_dimensionality(x, device="cpu")
    assert np.isfinite(float(got[0])) and np.isnan(float(got[1])) and np.isnan(float(got[2]))
    _close(got, j_twonn(x), ID_RTOL)


def test_self_distance_is_masked_by_writing_the_diagonal():
    """eye * inf is NaN off the diagonal outside jit (0 * inf): the port
    writes +inf on the diagonal and keeps every other distance."""
    assert torch.isnan(torch.eye(3) * float("inf"))[0, 1]
    dist = torch.rand(2, 5, 5)
    masked = g._mask_self(dist)
    eye = torch.eye(5, dtype=torch.bool).expand(2, 5, 5)
    assert torch.isinf(masked[eye]).all() and (masked[eye] > 0).all()
    assert torch.equal(masked[~eye], dist[~eye])


@pytest.mark.parametrize("n_windows", [1, 2, 5, 10])
def test_fixed_window_id_matches_tdax(n_windows):
    x = np.random.default_rng(3).normal(size=(2, 60, 16)).astype(np.float32)
    got = g.compute_fixed_window_id(x, n_windows, device="cpu")
    assert got.shape == (2, n_windows)
    _close(got, j_window_id(x, n_windows), ID_RTOL)


@pytest.mark.parametrize("seq,n_windows", [(60, 0), (60, -3), (5, 1), (8, 9), (30, 6),
                                           (40, 7), (11, 2)])
def test_fixed_window_id_nan_when_windows_are_too_small(seq, n_windows):
    x = np.random.default_rng(5).normal(size=(3, seq, 8)).astype(np.float32)
    got = g.compute_fixed_window_id(x, n_windows, device="cpu")
    assert got.shape == (3, max(n_windows, 1)) and torch.isnan(got).all()
    _close(got, j_window_id(x, n_windows), ID_RTOL)


# --- accuracy ---------------------------------------------------------------------

def _accuracy_inputs():
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 10, (3, 12))
    pred = gt.copy()
    pred[0, 3] = (pred[0, 3] + 1) % 10
    pred[2, 5] = (pred[2, 5] + 1) % 10
    labels = np.array([["pad", "ex1_answer", "ex1_answer", "ex1_answer",
                        "x", "ex2_answer", "ex2_answer", "pad",
                        "ex3_answer", "pad", "pad", "pad"]] * 3)
    labels[1, 8] = "pad"  # example 3 absent from sample 1: NaN there
    return gt, pred, labels


@pytest.mark.parametrize("mode", ["all", "first_token", "token_wise"])
def test_accuracy_by_example_matches_tdax(mode):
    gt, pred, labels = _accuracy_inputs()
    got = g.compute_accuracy_by_example(gt, pred, labels, mode)
    want = j_accuracy(gt, pred, labels, mode)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        g.compute_accuracy_by_example(torch.as_tensor(gt), torch.as_tensor(pred), labels, mode),
        want)


def test_accuracy_by_example_bad_mode_and_no_examples():
    gt, pred, labels = _accuracy_inputs()
    for fn in (g.compute_accuracy_by_example, j_accuracy):
        with pytest.raises(ValueError, match="Invalid accuracy_mode"):
            fn(gt, pred, labels, "nope")
    none = np.full((3, 12), "pad")
    assert g.compute_accuracy_by_example(gt, pred, none).shape == (3, 0)
    assert j_accuracy(gt, pred, none).shape == (3, 0)


# --- matrix entropy ---------------------------------------------------------------

@pytest.mark.parametrize("alpha", [1.0, 2.0, 0.5])
def test_matrix_entropy_matches_tdax(alpha):
    x = np.random.default_rng(5).normal(size=(3, 12, 24)).astype(np.float32)
    _close(g.matrix_entropy(x, alpha, device="cpu"), j_entropy(x, alpha), ENTROPY_RTOL)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_matrix_entropy_of_a_uniform_spectrum_is_log_n(alpha):
    x = np.eye(8, 16)[None].astype(np.float32)
    got = g.matrix_entropy(x, alpha, device="cpu")
    assert float(got[0]) == pytest.approx(np.log(8), abs=1e-4)
    _close(got, j_entropy(x, alpha), ENTROPY_RTOL)


def test_matrix_entropy_rank_deficient_and_leading_axes():
    """Zero eigenvalues (rank 3 of 10) give xlogy(0, 0) = 0; any leading axes."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 2, 10, 3)) @ rng.normal(size=(3, 20))).astype(np.float32)
    for alpha in (1.0, 2.0):
        got = g.matrix_entropy(x, alpha, device="cpu")
        assert got.shape == (2, 2)
        _close(got, j_entropy(x, alpha), ENTROPY_RTOL, atol=1e-5)


# --- Wasserstein ------------------------------------------------------------------

def _diagram(rng, n, inf=0):
    b = rng.uniform(0, 1, (n, 1))
    d = np.concatenate([b, b + rng.uniform(0.05, 1, (n, 1))], axis=1)
    if inf:
        d = np.concatenate([d, np.stack([rng.uniform(0, 1, inf), np.full(inf, np.inf)], 1)])
    return d


@pytest.mark.parametrize("order", [1.0, 2.0])
@pytest.mark.parametrize("na,nb,inf_a,inf_b", [(6, 6, 0, 0), (7, 3, 0, 0), (5, 8, 1, 1),
                                               (4, 4, 2, 2), (0, 5, 0, 0), (0, 0, 0, 0),
                                               (0, 0, 1, 1), (3, 3, 1, 0)])
def test_wasserstein_matches_tdax(order, na, nb, inf_a, inf_b):
    rng = np.random.default_rng(na * 31 + nb * 7 + inf_a)
    a, b = _diagram(rng, na, inf_a), _diagram(rng, nb, inf_b)
    got, want = wasserstein_distance(a, b, order), j_wasserstein(a, b, order)
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= WASSERSTEIN_TOL * max(1.0, abs(want))


def test_wasserstein_properties():
    d = _diagram(np.random.default_rng(0), 6)
    assert wasserstein_distance(d, d) == 0.0
    # W1 of a uniform +0.01 shift on 6 points = 6 * 0.01
    assert wasserstein_distance(d, d + 0.01) == pytest.approx(0.06, abs=1e-9)
    assert wasserstein_distance(np.zeros((0, 2)), np.zeros((0, 2))) == 0.0
