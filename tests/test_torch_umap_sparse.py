"""The port's edge-list UMAP (``tdax_torch/ops/umap/sparse_path.py``,
``lobpcg.py``) against tdax's, on the CPU.

Same numpy inputs from a seed into both packages.  tdax's random draws
are Threefry; where a stage draws, the test hands the port tdax's own
draws (``_x0``: the LOBPCG start; ``_negatives``: each epoch's
``randint(fold_in(key, epoch), (rows, 16))``).  Tolerances and why:

  * kNN distances: 2e-3 relative plus 2e-3 absolute, the f32
    expansion-form tolerance of tdax's own test (two matrix products
    round differently; the Euclidean expansion cancels at distance ~4);
    index sets equal wherever the exact gap between the k-th and the
    (k+1)-th neighbour is wider than that;
  * memberships: 1e-6 on identical kNN lists (one exp each);
  * build_sym_edges: bitwise (numpy on both sides, the same code);
  * LOBPCG on one operator and start: eigenvalues within 2e-5 relative
    (measured 4.8e-6), each Ritz vector's |cosine| with JAX's >= 0.999
    (measured 0.99994): the two eigh implementations round differently,
    and the f32 convergence test stops at residuals near 10 n eps |A x|;
  * the spectral inits from tdax's start: |cosine| >= 0.999 per column
    (the 1e-4 jitter and LOBPCG's residual level above);
  * PCA init: 2e-3 absolute per column up to sign (each side's 1e-4
    jitter, max over the cloud ~4.5e-4);
  * the layouts and the transform from tdax's init and draws, 50
    epochs: 2e-3 absolute on clouds of max-abs ~10 (measured <= 7.3e-4:
    pow and the sums round differently and the epochs amplify it; the
    schedules' discrete events are exact on both sides, the divisions
    being true f32 divisions).
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from tdax.metrics.silhouette import silhouette_score as j_silhouette_score
from tdax.ops.umap import fuzzy as jf
from tdax.ops.umap import sparse_path as js
from tdax.ops.umap.umap import find_ab_params

from tdax_torch.metrics.silhouette import silhouette_score
from tdax_torch.ops.umap import fuzzy as tf
from tdax_torch.ops.umap import sparse_path as ts
from tdax_torch.ops.umap.lobpcg import lobpcg_standard
from tdax_torch.ops.umap.umap import UMAP

A, B = find_ab_params(1.0, 0.1)
KNN_TOL = 2e-3
LAYOUT_TOL = 2e-3


def _t(a, long=False):
    t = torch.as_tensor(np.array(a))
    return t.long() if long else t


def _clusters(seed, n_per, dim, n_clusters=3, scale=8.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * scale
    x = np.concatenate([c + rng.normal(0, noise, (n_per, dim)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(n_clusters), n_per), rng


def _exact(a, b, metric):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if metric == "cosine":
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        return np.clip(1.0 - a @ b.T, 0.0, 2.0)
    return np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))


def _check_knn(port, tdax, exact, k, self_first):
    (pi, pd), (ji, jd) = port, tdax
    pi, pd, ji, jd = pi.numpy(), pd.numpy(), np.asarray(ji), np.asarray(jd)
    np.testing.assert_allclose(pd, jd, rtol=KNN_TOL, atol=KNN_TOL)
    srt = np.sort(exact, axis=1)
    clear = srt[:, k] - srt[:, k - 1] > 2 * KNN_TOL
    assert clear.mean() > 0.5
    for r in np.flatnonzero(clear):
        assert set(pi[r]) == set(ji[r]), r
    if self_first:
        assert (pi[:, 0] == np.arange(len(pi))).all() and (pd[:, 0] == 0).all()


def _bitwise(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_blocked_matches_tdax(metric):
    x = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
    port = ts.knn_blocked(_t(x), 8, metric, block_rows=128)
    _bitwise(port, ts.knn_blocked(_t(x), 8, metric, block_rows=512))  # the padded tail too
    _check_knn(port, js.knn_blocked(jnp.asarray(x), 8, metric, block_rows=128),
               _exact(x, x, metric), 8, self_first=True)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_blocked_cross_matches_tdax(metric):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(150, 12)).astype(np.float32)
    b = rng.normal(size=(90, 12)).astype(np.float32)
    port = ts.knn_blocked_cross(_t(a), _t(b), 6, metric, block_rows=64)
    _bitwise(port, ts.knn_blocked_cross(_t(a), _t(b), 6, metric, block_rows=512))
    _check_knn(port, js.knn_blocked_cross(jnp.asarray(a), jnp.asarray(b), 6, metric),
               _exact(a, b, metric), 6, self_first=False)


def _tdax_graph(x, k, metric="euclidean"):
    """tdax's kNN lists, calibration, memberships and symmetric edges."""
    idx, dists = js.knn_blocked(jnp.asarray(x), k, metric)
    sigma, rho = jf.smooth_knn_dist(dists, float(k))
    w = jf.membership_strengths_knn(idx, dists, sigma, rho)
    return (np.asarray(idx), np.asarray(dists), np.asarray(sigma), np.asarray(rho),
            np.asarray(w))


def test_membership_strengths_knn_matches_tdax():
    x, _, _ = _clusters(1, 40, 8)
    idx, dists, sigma, rho, w = _tdax_graph(x, 6)
    got = tf.membership_strengths_knn(_t(idx, True), _t(dists), _t(sigma), _t(rho)).numpy()
    np.testing.assert_allclose(got, w, atol=1e-6)
    assert (got[:, 0] == 0).all()  # the self entries


def test_build_sym_edges_bitwise_and_dense_symmetrization():
    """tdax's edges bitwise, and W == the dense A + A^T - A o A^T from
    the same lists (tests/test_umap_sparse.py's check)."""
    x = np.random.default_rng(1).normal(size=(80, 8)).astype(np.float32)
    idx, _, _, _, w = _tdax_graph(x, 6)
    got = ts.build_sym_edges(idx, w)
    for g, e in zip(got, js.build_sym_edges(idx, w)):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    for mix in (0.0, 0.5):
        for g, e in zip(ts.build_sym_edges(idx, w, mix), js.build_sym_edges(idx, w, mix)):
            np.testing.assert_array_equal(g, e)
    head, tail, wgt = got
    a = np.zeros((80, 80), np.float64)
    np.maximum.at(a, (np.repeat(np.arange(80), 6), idx.reshape(-1)),
                  np.asarray(w, np.float64).reshape(-1))
    np.fill_diagonal(a, 0.0)
    rebuilt = np.zeros((80, 80), np.float64)
    rebuilt[head, tail] = wgt
    np.testing.assert_allclose(rebuilt, a + a.T - a * a.T, rtol=1e-5, atol=1e-6)


def _box_graph(n=2100, seed=21):
    """The symmetric edges (the port's, handed to both packages) of a
    connected 4:2:1 box, whose bottom Laplacian eigenvalues are distinct."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, 3)) * np.array([4.0, 2.0, 1.0])).astype(np.float32)
    idx, dists = ts.knn_blocked(_t(x), 15, "euclidean")
    sigma, rho = tf.smooth_knn_dist(dists, 15.0)
    w = tf.membership_strengths_knn(idx, dists, sigma, rho)
    return ts.build_sym_edges(idx.numpy(), w.numpy(), 1.0)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


@pytest.mark.parametrize("case", ["graph", "dense"])
def test_lobpcg_matches_jax(case):
    """One operator, one start: JAX's lobpcg_standard and the port's."""
    from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg
    rng = np.random.default_rng(3)
    if case == "graph":  # B = I + M - 2 v0 v0^T of a 600-point box, as a dense matrix
        head, tail, w = _box_graph(600, 4)
        wd = np.zeros((600, 600), np.float64)
        wd[head, tail] = w
        deg = wd.sum(1)
        m = wd / np.sqrt(deg)[:, None] / np.sqrt(deg)[None, :]
        v0 = np.sqrt(deg) / np.linalg.norm(np.sqrt(deg))
        op = (np.eye(600) + m - 2 * np.outer(v0, v0)).astype(np.float32)
    else:
        g = rng.normal(size=(400, 400))
        op = ((g + g.T) / 2).astype(np.float32)
    x0 = rng.normal(size=(op.shape[0], 5)).astype(np.float32)
    theta_j, u_j, it_j = j_lobpcg(
        lambda v: jnp.dot(jnp.asarray(op), v, precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(x0), m=200)
    op_t = _t(op)
    theta_t, u_t, it_t = lobpcg_standard(lambda v: op_t @ v, _t(x0), m=200)
    np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=2e-5)
    assert (_cosines(u_t.numpy(), u_j) >= 0.999).all()
    assert abs(it_t - int(it_j)) <= 2 and it_t < 200


def test_lobpcg_checks_its_inputs():
    with pytest.raises(ValueError, match="search dim"):
        lobpcg_standard(lambda v: v, torch.zeros(20, 4))
    with pytest.raises(ValueError, match="must be"):
        lobpcg_standard(lambda v: v[:-1], torch.ones(50, 2))


def test_spectral_init_lobpcg_matches_tdax_and_dense_eigh(monkeypatch):
    """From tdax's start and at the port's convergence rule (tdax's
    LOBPCG call given tol = eps / sqrt(n)): tdax's columns up to sign;
    and, as tdax's own test, the span of dense eigh's bottom non-trivial
    eigenvectors."""
    import jax.experimental.sparse.linalg as jsl
    head, tail, w = _box_graph()
    n, key = 2100, jax.random.PRNGKey(42)
    real = jsl.lobpcg_standard
    tol = float(np.finfo(np.float32).eps) / np.sqrt(n)
    monkeypatch.setattr(jsl, "lobpcg_standard", lambda A, X, m=100: real(A, X, m=m, tol=tol))
    # the function under jax.jit's wrapper: a trace cached by another test
    # would keep JAX's default tolerance
    want = np.asarray(js.spectral_init_lobpcg.__wrapped__(
        jnp.asarray(head), jnp.asarray(tail), jnp.asarray(w), n, 3, key))
    x0 = np.array(jax.random.normal(key, (n, 5), jnp.float32))
    got, iterations = ts.spectral_init_lobpcg(_t(head, True), _t(tail, True), _t(w), n, 3,
                                              42, _x0=x0)
    got = got.numpy()
    assert np.isfinite(got).all() and 0 < iterations < 400
    assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)

    wd = np.zeros((n, n))
    wd[head, tail] = w
    deg = wd.sum(1)
    inv = 1.0 / np.sqrt(deg)
    vals, vecs = scipy.linalg.eigh(np.eye(n) - inv[:, None] * wd * inv[None, :],
                                   subset_by_index=[0, 3])
    assert vals[1] > 1e-6
    q, _ = np.linalg.qr(got)
    for j in range(3):
        assert np.linalg.norm(q.T @ vecs[:, 1 + j]) > 0.9, j


def test_spectral_init_lobpcg_converges_at_100k_points():
    """tdax's fault at scale, repaired: JAX's default tolerance 10 n eps
    (...) passes every pair after one iteration at 100,000 points (three
    random 5-regular components here), leaving the init near its random
    start; the port's 10 sqrt(n) eps rule iterates on, and its first two
    columns separate the components (within m = 20 iterations here: the
    guard vectors, in the random graphs' dense bulk spectrum, take ~100)."""
    n_per, rng = 33_334, np.random.default_rng(0)
    n = 3 * n_per
    base = np.repeat(np.arange(3) * n_per, n_per)
    idx = np.concatenate([np.arange(n)[:, None],
                          base[:, None] + rng.integers(0, n_per, (n, 5))], 1)
    w = np.ones(idx.shape, np.float32)
    head, tail, wgt = (_t(v) for v in ts.build_sym_edges(idx, w))
    head, tail = head.long(), tail.long()
    seg, v0, coef = ts._normalized_adjacency(head, tail, wgt, n)

    def bmat(v):
        return v + seg.sum(coef[:, None] * v[tail]) - 2.0 * v0[:, None] * (v0 @ v)[None, :]

    x0 = torch.randn((n, 4), generator=torch.Generator().manual_seed(0))
    _, _, jax_default_iterations = lobpcg_standard(bmat, x0 - v0[:, None] * (v0 @ x0), m=400)
    assert jax_default_iterations == 1
    emb, iterations = ts.spectral_init_lobpcg(head, tail, wgt, n, 2, 0, m=20)
    assert iterations > 1
    labels = np.repeat(np.arange(3), n_per)
    sub = np.random.default_rng(1).choice(n, 3000, replace=False)
    assert silhouette_score(emb.numpy()[sub], labels[sub], device="cpu") > 0.9


def _two_cliques():
    head, tail = [], []
    for base in (0, 32):
        for i in range(32):
            for j in range(i + 1, 32):
                head += [base + i, base + j]
                tail += [base + j, base + i]
    order = np.lexsort((tail, head))
    return (np.array(head, np.int32)[order], np.array(tail, np.int32)[order],
            np.ones(len(head), np.float32))


@pytest.mark.parametrize("init", ["lobpcg", "orthogonal_iteration"])
def test_spectral_inits_separate_components(init):
    """Two disconnected cliques land apart: column 0 is the component indicator."""
    head, tail, w = (_t(v, long=v.dtype == np.int32) for v in _two_cliques())
    if init == "lobpcg":
        emb, _ = ts.spectral_init_lobpcg(head, tail, w, 64, 2, 0, m=100)
    else:
        emb = ts.spectral_init_edges(head, tail, w, 64, 2, 0)
    c0a, c0b = emb[:32, 0].numpy(), emb[32:, 0].numpy()
    assert (np.sign(c0a) == np.sign(c0a[0])).all() and (np.sign(c0b) == np.sign(c0b[0])).all()
    assert np.sign(c0a[0]) != np.sign(c0b[0])
    assert abs(c0a.mean() - c0b.mean()) > 5 * max(c0a.std(), c0b.std())


def test_spectral_init_edges_matches_tdax():
    head, tail, w = _box_graph(300, 5)
    key = jax.random.PRNGKey(1)
    want = np.asarray(js.spectral_init_edges(jnp.asarray(head), jnp.asarray(tail),
                                             jnp.asarray(w), 300, 2, key))
    x0 = np.array(jax.random.normal(key, (300, 2), jnp.float32))
    got = ts.spectral_init_edges(_t(head, True), _t(tail, True), _t(w), 300, 2, 1,
                                 _x0=x0).numpy()
    assert (_cosines(got, want) >= 0.999).all(), _cosines(got, want)


def test_pca_init_matches_tdax():
    x, _, _ = _clusters(9, 60, 16)
    want = np.asarray(js.pca_init(jnp.asarray(x), 2, jax.random.PRNGKey(1)))
    got = ts.pca_init(_t(x), 2, 1).numpy()
    for c in range(2):
        sign = np.sign((want[:, c] * got[:, c]).sum())
        np.testing.assert_allclose(sign * got[:, c], want[:, c], atol=2e-3)


def _tdax_fit_inputs(seed=9, n_per=80):
    """tdax's edges of a 3-cluster cloud and tdax's PCA init of it."""
    x, labels, _ = _clusters(seed, n_per, 16)
    idx, _, _, _, w = _tdax_graph(x, 10)
    head, tail, wgt = js.build_sym_edges(idx, w, 1.0)
    init = np.asarray(js.pca_init(jnp.asarray(x), 2, jax.random.PRNGKey(1)))
    return x, labels, head, tail, wgt, init


def _tdax_draws(key, rows, high, n_epochs):
    draws = [np.array(jax.random.randint(jax.random.fold_in(key, e), (rows, ts.NEG_POOL),
                                           0, high)) for e in range(n_epochs)]
    return lambda epoch: draws[epoch]


def test_optimize_layout_edges_matches_tdax():
    x, _, head, tail, wgt, init = _tdax_fit_inputs()
    n, key = len(x), jax.random.PRNGKey(2)
    want = np.asarray(js.optimize_layout_edges(
        jnp.asarray(init), jnp.asarray(head), jnp.asarray(tail), jnp.asarray(wgt), n, 50, key,
        A, B))
    got = ts.optimize_layout_edges(_t(init), _t(head, True), _t(tail, True), _t(wgt), n, 50,
                                   0, A, B, _negatives=_tdax_draws(key, n, n, 50)).numpy()
    assert np.abs(want).max() > 5.0
    np.testing.assert_allclose(got, want, atol=LAYOUT_TOL)


def test_optimize_layout_edges_fixed_tail_matches_tdax():
    rng = np.random.default_rng(13)
    n_train, n_new, k = 120, 53, 8
    train_emb = rng.normal(size=(n_train, 2)).astype(np.float32) * 4
    head = np.repeat(np.arange(n_new, dtype=np.int32), k)
    tail = rng.integers(0, n_train, n_new * k).astype(np.int32)
    wgt = rng.uniform(0.2, 1.0, n_new * k).astype(np.float32)
    init = rng.normal(size=(n_new, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(js.optimize_layout_edges_fixed_tail(
        jnp.asarray(init), jnp.asarray(train_emb), jnp.asarray(head), jnp.asarray(tail),
        jnp.asarray(wgt), 50, key, A, B, initial_alpha=0.25))
    got = ts.optimize_layout_edges_fixed_tail(
        _t(init), _t(train_emb), _t(head, True), _t(tail, True), _t(wgt), 50, 0, A, B,
        initial_alpha=0.25, _negatives=_tdax_draws(key, n_new, n_train, 50)).numpy()
    np.testing.assert_allclose(got, want, atol=LAYOUT_TOL)


def test_transform_sparse_matches_tdax():
    x_tr, _, rng = _clusters(5, 60, 24)
    x_new = (x_tr[::6] + rng.normal(0, 0.3, x_tr[::6].shape)).astype(np.float32)
    train_emb = rng.normal(size=(len(x_tr), 2)).astype(np.float32) * 5
    key = jax.random.PRNGKey(4)
    args = (10, "cosine", 50)
    rest = (A, B, 1.0, 5, 1.0, 1.0)
    want = js.transform_sparse(x_new, jnp.asarray(x_tr), train_emb, *args, key, *rest)
    got = ts.transform_sparse(x_new, _t(x_tr), train_emb, *args, 0, *rest,
                              _negatives=_tdax_draws(key, len(x_new), len(x_tr), 50))
    assert got.shape == (len(x_new), 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LAYOUT_TOL)


# --- tdax's structure tests (tests/test_umap_sparse.py), on the port -------------------

def _sparse_umap(x, threshold=16, **kw):
    u = UMAP(n_components=2, random_state=42, device="cpu", **kw)
    u.sparse_threshold = threshold  # force the edge-list path
    return u, u.fit_transform(x)


def test_sparse_cluster_separation():
    x, labels, _ = _clusters(2, 400, 32)
    _, emb = _sparse_umap(x, n_neighbors=15, n_epochs=150)
    assert np.isfinite(emb).all()
    s = silhouette_score(emb, labels, device="cpu")
    assert s > 0.7, s
    assert abs(s - j_silhouette_score(emb, labels)) < 1e-5


def test_sparse_circle_keeps_one_dominant_loop():
    from tdax_torch.ops.rips import rips
    rng = np.random.default_rng(3)
    theta = np.linspace(0, 2 * np.pi, 600, endpoint=False)
    basis = np.linalg.qr(rng.normal(size=(20, 2)))[0]
    x = np.stack([np.cos(theta), np.sin(theta)], 1) @ basis.T * 5 \
        + rng.normal(0, 0.05, (600, 20))
    _, emb = _sparse_umap(x.astype(np.float32), n_neighbors=15, n_epochs=400)
    h1 = rips(emb.astype(np.float64), maxdim=1)["dgms"][1]
    pers = np.sort(h1[:, 1] - h1[:, 0])[::-1]
    assert len(pers) > 0 and pers[0] > 3 * (pers[1] if len(pers) > 1 else 0.0), pers[:3]


def test_sparse_repeats_bitwise_and_dispatches(monkeypatch):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 0.5, (100, 12)),
                        rng.normal(6, 0.5, (100, 12))]).astype(np.float32)
    labels = np.repeat([0, 1], 100)
    _, e1 = _sparse_umap(x, n_neighbors=10, n_epochs=150)
    _, e2 = _sparse_umap(x, n_neighbors=10, n_epochs=150)
    np.testing.assert_array_equal(e1, e2)
    assert silhouette_score(e1, labels, device="cpu") > 0.6
    assert ts.LAST_TIMINGS["init_iterations"] > 0
    assert set(ts.LAST_TIMINGS) == {"upload_s", "knn_calib_s", "sym_s", "init_s", "layout_s",
                                    "init_iterations"}

    # the instance's threshold decides, as tdax's: the default keeps 200
    # points dense, and fit past it never reaches the dense _embed
    import tdax_torch.ops.umap.umap as tu
    assert UMAP.sparse_threshold == 2048 and UMAP().sparse_threshold == 2048
    calls = []
    real = tu._embed
    monkeypatch.setattr(tu, "_embed", lambda *a, **k: calls.append(1) or real(*a, **k))
    UMAP(n_components=2, n_neighbors=10, n_epochs=5, device="cpu").fit(x)
    assert calls == [1]
    _sparse_umap(x, threshold=199, n_neighbors=10, n_epochs=5)
    assert calls == [1]
    _sparse_umap(x, threshold=200, n_neighbors=10, n_epochs=5)
    assert calls == [1, 1]


def test_sparse_transform_places_new_points():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(3, 24)) * 8
    x_tr = np.concatenate([c + rng.normal(0, 0.5, (150, 24)) for c in centers])
    x_new = np.concatenate([c + rng.normal(0, 0.5, (40, 24)) for c in centers])
    lab_tr, lab_new = np.repeat(np.arange(3), 150), np.repeat(np.arange(3), 40)
    u, emb_tr = _sparse_umap(x_tr.astype(np.float32), n_neighbors=10, n_epochs=150)
    before = np.array(u.embedding_)
    emb_new = u.transform(x_new.astype(np.float32))
    np.testing.assert_array_equal(before, u.embedding_)
    assert np.isfinite(emb_new).all()
    cents = np.stack([emb_tr[lab_tr == c].mean(0) for c in range(3)])
    acc = (np.argmin(np.linalg.norm(emb_new[:, None] - cents[None], axis=-1), 1)
           == lab_new).mean()
    assert acc > 0.95, acc
    np.testing.assert_array_equal(emb_new, u.transform(x_new.astype(np.float32)))


def test_sparse_transform_agrees_with_dense_geometry(monkeypatch):
    """A dense fit: the dense transform and the forced edge-list one make
    the same cluster assignments; transform dispatches on n_new x n_train."""
    import tdax_torch.ops.umap.sparse_path as sp
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(2, 16)) * 10
    x_tr = np.concatenate([c + rng.normal(0, 0.5, (80, 16)) for c in centers])
    x_new = np.concatenate([c + rng.normal(0, 0.5, (30, 16)) for c in centers])
    lab_tr, lab_new = np.repeat(np.arange(2), 80), np.repeat(np.arange(2), 30)
    u = UMAP(n_components=2, n_neighbors=8, n_epochs=100, random_state=42, device="cpu")
    emb_tr = u.fit_transform(x_tr.astype(np.float32))
    calls = []
    real = sp.transform_sparse
    monkeypatch.setattr(sp, "transform_sparse", lambda *a, **k: calls.append(1) or real(*a, **k))
    u.sparse_threshold = 98  # 60 x 160 = 9600 pairs <= 98^2: dense
    dense_new = u.transform(x_new.astype(np.float32))
    assert calls == []
    u.sparse_threshold = 97  # 9600 > 97^2: the edge list
    sparse_new = u.transform(x_new.astype(np.float32))
    assert calls == [1]
    cents = np.stack([emb_tr[lab_tr == c].mean(0) for c in range(2)])
    for emb_new in (dense_new, sparse_new):
        d = np.linalg.norm(emb_new[:, None] - cents[None], axis=-1)
        assert (np.argmin(d, 1) == lab_new).all()


def test_sparse_path_turns_tf32_off():
    """A cloud tensor passed in stays where it lies, and the kNN still
    runs in true f32 whatever the process switches said before."""
    x, _, _ = _clusters(2, 30, 8)
    u = UMAP(n_components=2, n_neighbors=5, n_epochs=3)  # no device: the tensor's own
    u.sparse_threshold = 16
    torch.backends.cuda.matmul.allow_tf32 = True
    u.fit(torch.as_tensor(x))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.backends.cuda.matmul.allow_tf32 = True
    u.transform(torch.as_tensor(x[:20]))
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_sparse_fit_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u = UMAP()
    u.sparse_threshold = 16
    with pytest.raises(RuntimeError, match="no CUDA device"):
        u.fit(np.zeros((40, 3), np.float32))


def test_shared_sweep_past_the_threshold_is_the_serial_loop(monkeypatch):
    """The shared mode past a (lowered) threshold: UMAP.fit on the last
    layer with n_neighbors = k, then transform of every layer, on the
    edge list, as tdax's embed_layers."""
    import tdax_torch.ops.umap.umap as tu
    from tdax_torch.config import SweepConfig, UMAPConfig
    from tdax_torch.pipeline.tda_sweep import embed_and_silhouettes
    monkeypatch.setattr(tu.UMAP, "sparse_threshold", 64)
    rng = np.random.default_rng(11)
    clouds = rng.normal(size=(3, 90, 16)).astype(np.float32)
    clouds[:, :30] += 4.0
    ucfg = UMAPConfig(n_epochs=30, n_neighbors=8)
    labels = {"g": ["a"] * 30 + ["b"] * 60}
    embs, sils = embed_and_silhouettes(clouds, SweepConfig(reducer_mode="shared", umap=ucfg),
                                       labels, device="cpu")
    reducer = tu.UMAP.from_config(ucfg, device="cpu")
    reducer.fit(clouds[-1])
    assert ts.LAST_TIMINGS["init_iterations"] > 0  # the edge-list fit
    serial = np.stack([reducer.transform(c) for c in clouds])
    np.testing.assert_array_equal(embs, serial)
    assert embs.shape == (3, 90, 3) and sils["g"].shape == (3,)
    with pytest.raises(ValueError, match="dense-path only"):
        tu.shared_transform_batched(clouds, ucfg, device="cpu")
