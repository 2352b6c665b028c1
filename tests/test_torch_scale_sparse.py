"""The port's sparse scale path and sparse bottleneck against tdax, on the CPU.

Same numpy inputs from a seed into both packages.  Tolerances:

  * ``csr_from_knn``, ``rips_sparse`` and ``bottleneck_distance_sparse``
    are the same numpy code or the same engine on the same input:
    bitwise / exactly equal;
  * the threshold: both sides take the median of expansion-form
    distances from one f32 matrix product each, summed in other orders
    (rtol 1e-6);
  * the scale path's bars: the edge values are difference-form sums in
    f32 in other orders (finite bars within 1e-5, the same edges and the
    same infinite bars);
  * refined values against f64 difference-form distances: 1e-6 relative
    (an f32 sum of 32 squares and a square root).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdax.metrics.persistence import bottleneck_distance as j_bottleneck
from tdax.metrics.persistence import bottleneck_distance_sparse as j_bottleneck_sparse
from tdax.ops.distances import pairwise_euclidean_np
from tdax.ops.rips.sparse import csr_from_knn as j_csr_from_knn
from tdax.ops.rips.sparse import rips_sparse as j_rips_sparse
from tdax.pipeline.scale import _select_threshold as j_select_threshold
from tdax.pipeline.scale import rips_at_scale_sparse as j_rips_at_scale_sparse

import tdax_torch.metrics.persistence as persistence
from tdax_torch.metrics.persistence import bottleneck_distance, bottleneck_distance_sparse
from tdax_torch.ops.rips import csr_from_knn, rips_sparse
from tdax_torch.pipeline.scale import (_median, _refine_edge_values, _select_threshold,
                                       rips_at_scale_sparse)

BRANCHES = {"fused": {}, "blocked32": {"block_rows": 32, "fused_max": 0},
            "blocked100": {"block_rows": 100, "fused_max": 0}}


def _sphere_knn():
    """tests/test_scale_ops.py:108-131: 80 points on the 2-sphere, k = 40."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=(80, 3))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    dist = pairwise_euclidean_np(z).astype(np.float32)
    knn_idx = np.argsort(dist, axis=1)[:, :40]
    knn_dist = np.take_along_axis(dist, knn_idx, axis=1)
    return knn_idx, knn_dist, float(np.median(knn_dist[:, 25]))


def _cloud(seed: int, n: int = 100):
    """tests/test_scale_ops.py:163-215: a 3-sphere in 32-d."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return (z @ rng.normal(size=(4, 32))).astype(np.float32)


def _assert_bars_close(got, want, atol=1e-5):
    assert len(got) == len(want)
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"dim {p}: {g.shape} vs {w.shape}"
        assert np.isinf(g[:, 1]).sum() == np.isinf(w[:, 1]).sum(), f"dim {p}"
        np.testing.assert_allclose(np.where(np.isfinite(g), g, -1), np.where(np.isfinite(w), w, -1),
                                   rtol=0, atol=atol, err_msg=f"dim {p}")


def test_csr_from_knn_equals_tdax_bitwise():
    knn_idx, knn_dist, thresh = _sphere_knn()
    got = csr_from_knn(knn_idx, knn_dist, thresh)
    want = j_csr_from_knn(knn_idx, knn_dist, thresh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_csr_completeness_guard_raises_like_tdax():
    rng = np.random.default_rng(12)  # tests/test_scale_ops.py:134-145
    dist = pairwise_euclidean_np(rng.normal(size=(30, 3))).astype(np.float32)
    knn_idx = np.argsort(dist, axis=1)[:, :5]
    knn_dist = np.take_along_axis(dist, knn_idx, axis=1)
    for fn in (csr_from_knn, j_csr_from_knn):
        with pytest.raises(ValueError, match="increase k"):
            fn(knn_idx, knn_dist, thresh=float(dist.max()))


def test_rips_sparse_bars_equal_tdax_bitwise():
    indptr, indices, data = csr_from_knn(*_sphere_knn())
    got = rips_sparse(indptr, indices, data, maxdim=2)
    want = j_rips_sparse(indptr, indices, data, maxdim=2)
    assert len(got) == 3 and len(got[2]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="maxdim <= 3"):
        rips_sparse(indptr, indices, data, maxdim=4)


@pytest.mark.parametrize("sample", [64, 63])
def test_select_threshold_matches_tdax(sample):
    """64 rows (an even count: the median is the midpoint of the two
    middle values, as jnp.median) and 63 (odd)."""
    x = np.random.default_rng(7).normal(size=(300, 24)).astype(np.float32)
    got = _select_threshold(torch.as_tensor(x), 300, 11, sample=sample)
    want = j_select_threshold(jnp.asarray(x), 300, 11, sample=sample)
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def test_median_is_the_midpoint():
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(_median(v)) == 2.5
    assert float(_median(v[:3])) == 3.0
    assert float(_median(torch.tensor([7.0]))) == 7.0


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("seed", [13, 14, 15])
def test_rips_at_scale_sparse_matches_tdax(seed, branch):
    x = _cloud(seed)
    got = rips_at_scale_sparse(x, maxdim=2, target_degree=25, device="cpu", **BRANCHES[branch])
    want = j_rips_at_scale_sparse(x, maxdim=2, target_degree=25, **BRANCHES[branch])
    assert got["thresh"] == pytest.approx(want["thresh"], rel=1e-6, abs=0)
    assert got["n_edges"] == want["n_edges"]
    _assert_bars_close(got["dgms"], want["dgms"])
    # tdax's stage keys, tpu_idle_s named device_idle_s
    keys = set(want["timings"]) - {"tpu_idle_s"} | {"device_idle_s"}
    assert set(got["timings"]) == keys
    assert all(v >= 0 for v in got["timings"].values())


def test_rips_at_scale_sparse_blocked_matches_unblocked():
    """tests/test_scale_ops.py:174-195 on the port: any block size, the
    same filtration; the fused branch the same edges."""
    x = _cloud(14)
    a = rips_at_scale_sparse(x, maxdim=1, target_degree=25, block_rows=32, fused_max=0,
                             device="cpu")
    b = rips_at_scale_sparse(x, maxdim=1, target_degree=25, block_rows=100, fused_max=0,
                             device="cpu")
    f = rips_at_scale_sparse(x, maxdim=1, target_degree=25, device="cpu")
    assert a["n_edges"] == b["n_edges"] == f["n_edges"]
    for p in range(2):
        np.testing.assert_array_equal(a["dgms"][p], b["dgms"][p])
    _assert_bars_close(a["dgms"], f["dgms"])


@pytest.mark.parametrize("fused", [True, False])
def test_rips_at_scale_sparse_raises_on_truncation(fused):
    """A row with more in-threshold neighbours than its budget raises, on
    both branches, as tdax's (tests/test_scale_ops.py:233-246)."""
    x = (np.random.default_rng(3).normal(size=(60, 8)) * 1e-3).astype(np.float32)
    kwargs = {} if fused else {"fused_max": 0, "block_rows": 32}
    for fn, extra in ((rips_at_scale_sparse, {"device": "cpu"}), (j_rips_at_scale_sparse, {})):
        with pytest.raises(ValueError, match="degree_headroom"):
            fn(x, maxdim=1, target_degree=8, degree_headroom=1.0, **kwargs, **extra)


def test_tensor_input_equals_numpy_input():
    """A tensor stays on its device (here the CPU) and gives the diagrams
    of the same cloud passed as numpy."""
    x = _cloud(15, 80)
    a = rips_at_scale_sparse(x, maxdim=1, target_degree=20, device="cpu")
    b = rips_at_scale_sparse(torch.as_tensor(x), maxdim=1, target_degree=20)
    assert a["n_edges"] == b["n_edges"] and a["thresh"] == b["thresh"]
    for p in range(2):
        np.testing.assert_array_equal(a["dgms"][p], b["dgms"][p])


@pytest.mark.parametrize("branch", ["fused", "blocked32"])
def test_refined_csr_is_symmetric_and_accurate(branch):
    """The CSR the engine gets: indptr monotone, each row's columns
    ascending and unique, no self entry, (r, c) present iff (c, r), the
    two values bitwise equal, and within 1e-6 relative of f64
    difference-form distances."""
    x = _cloud(13)
    out = rips_at_scale_sparse(x, maxdim=1, target_degree=25, device="cpu", _with_csr=True,
                               **BRANCHES[branch])
    csr = out["_csr"]
    indptr, indices, data = csr["indptr"], csr["indices"], csr["data"]
    n = len(indptr) - 1
    assert indptr.dtype == np.int64 and indices.dtype == np.int32 and data.dtype == np.float32
    assert indptr[0] == 0 and (np.diff(indptr) >= 0).all() and indptr[-1] == len(indices)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    same_row = rows[1:] == rows[:-1]
    assert (np.diff(indices.astype(np.int64))[same_row] > 0).all()
    assert (rows != indices).all()
    key = rows * n + indices
    pos = np.searchsorted(key, indices.astype(np.int64) * n + rows)
    assert (key[np.minimum(pos, len(key) - 1)] == indices.astype(np.int64) * n + rows).all()
    np.testing.assert_array_equal(data.view(np.uint32), data[pos].view(np.uint32))
    assert out["n_edges"] == len(indices) // 2 and csr["added_by_union"] == 0
    exact = pairwise_euclidean_np(x)[rows, indices]
    np.testing.assert_allclose(data, exact, rtol=1e-6, atol=0)
    assert (data <= out["thresh"] * (1 + 1e-4)).all()


def test_refinement_blocks_give_the_one_pass_values():
    """Edges refined a few at a time give the values of one pass, within
    1e-6 relative of f64 difference-form distances."""
    x = torch.as_tensor(_cloud(13))
    rng = np.random.default_rng(0)
    r = torch.as_tensor(rng.integers(0, 100, 50))
    c = torch.as_tensor(rng.integers(0, 100, 50))
    whole = _refine_edge_values(x, r, c)
    torch.testing.assert_close(_refine_edge_values(x, r, c, block=7), whole, rtol=0, atol=0)
    exact = pairwise_euclidean_np(x.numpy())[r.numpy(), c.numpy()]
    np.testing.assert_allclose(whole.numpy(), exact, rtol=1e-6, atol=1e-6)


def test_sparse_path_turns_tf32_off():
    """The blocked branch's products are true f32 whatever the process
    switches said before the call."""
    torch.backends.cuda.matmul.allow_tf32 = True
    rips_at_scale_sparse(_cloud(13, 60), maxdim=0, target_degree=10, fused_max=0,
                         device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_rips_at_scale_sparse_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rips_at_scale_sparse(_cloud(13, 40), maxdim=1, target_degree=10)


# --- the sparse bottleneck --------------------------------------------------------

def _random_diagram(rng, n, spread=1.0):
    b = rng.uniform(0, 1, (n, 1))
    return np.concatenate([b, b + rng.exponential(spread, (n, 1))], axis=1)


def _metric_cases():
    """tests/test_metrics.py:109-135's six cases, drawn in its order."""
    rng = np.random.default_rng(7)
    d = _random_diagram(rng, 60)
    cases = {"twins": (d, d + rng.uniform(-0.01, 0.01, d.shape)),
             "unequal_n": (d, _random_diagram(rng, 45))}
    noisy = np.concatenate([d, _random_diagram(rng, 200, 0.005)])
    cases["diagonal_noise"] = (noisy, d)
    cases["disjoint"] = (_random_diagram(rng, 30) + 5.0, _random_diagram(rng, 30))
    cases["empty_side"] = (np.zeros((0, 2)), _random_diagram(rng, 12))
    inf_a = np.concatenate([d[:20], [[0.1, np.inf], [0.6, np.inf]]])
    inf_b = np.concatenate([d[:20] * 1.001, [[0.12, np.inf], [0.58, np.inf]]])
    cases["paired_infs"] = (inf_a, inf_b)
    return cases


CASES = _metric_cases()


@pytest.mark.parametrize("case", list(CASES))
def test_bottleneck_sparse_equals_tdax(case):
    a, b = CASES[case]
    for x, y in ((a, b), (b, a)):
        got = bottleneck_distance_sparse(x, y)
        assert got == j_bottleneck_sparse(x, y)
        assert got == pytest.approx(j_bottleneck(x, y), rel=1e-9, abs=1e-12)


def test_bottleneck_sparse_mismatched_infinities():
    a, b = np.array([[0.0, np.inf]]), np.array([[0.0, 1.0]])
    assert bottleneck_distance_sparse(a, b) == j_bottleneck_sparse(a, b) == np.inf


def _h0_pair(n=800, shift=0.5):
    """Two well-separated H0-shaped diagrams (all births 0): the lower
    bound does not settle them, so the exact finish runs."""
    rng = np.random.default_rng(0)
    return (np.stack([np.zeros(n), rng.uniform(0, 1, n)], 1),
            np.stack([np.zeros(n), rng.uniform(0, 1, n) + shift], 1))


def test_bottleneck_sparse_bounded_finish_equals_tdax(monkeypatch):
    """The exact finish gathers its candidates chunk by chunk (a tiny
    chunk here) and still returns tdax's answer."""
    a, b = _h0_pair()
    finishes = []
    inner = persistence._pair_costs_in_window
    monkeypatch.setattr(persistence, "FINISH_CHUNK_PAIRS", 5000)
    monkeypatch.setattr(persistence, "_pair_costs_in_window",
                        lambda *args: finishes.append(args[2:]) or inner(*args))
    assert bottleneck_distance_sparse(a, b) == j_bottleneck_sparse(a, b)
    assert len(finishes) == 1


def test_bottleneck_finish_chunks_hold_few_pairs(monkeypatch):
    """Each chunk of the finish holds at most FINISH_CHUNK_PAIRS window
    candidates, and together they give tdax's whole-array candidates."""
    a, b = _h0_pair()
    lo, hi = 0.1, 0.6
    sizes = []
    inner = persistence._pairs_within

    def counted(pa, pb, eps):
        ai, bj = inner(pa, pb, eps)
        sizes.append(len(ai))
        return ai, bj

    monkeypatch.setattr(persistence, "FINISH_CHUNK_PAIRS", 5000)
    monkeypatch.setattr(persistence, "_pairs_within", counted)
    got = persistence._pair_costs_in_window(a, b, lo, hi)
    ai, bj = inner(a, b, hi)
    d = np.max(np.abs(a[ai] - b[bj]), axis=1)
    np.testing.assert_array_equal(np.sort(got), np.sort(d[(d > lo) & (d <= hi)]))
    assert len(sizes) > 10 and max(sizes) <= 5000 < len(ai)


def test_bottleneck_dispatches_past_2048_bars(monkeypatch):
    rng = np.random.default_rng(1)
    d = _random_diagram(rng, 1100)
    e = d + rng.uniform(-1e-3, 1e-3, d.shape)
    calls = []
    inner = persistence.bottleneck_distance_sparse
    monkeypatch.setattr(persistence, "bottleneck_distance_sparse",
                        lambda *args: calls.append(1) or inner(*args))
    assert bottleneck_distance(d, e) == j_bottleneck(d, e)
    assert calls == [1]
