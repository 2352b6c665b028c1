"""UMAP past the dense threshold on fixed-size edge lists (port of
``tdax/ops/umap/sparse_path.py``).

The dense path (fuzzy.py, layout.py) holds an [n, n] fuzzy graph and an
[nh, nt, d] epoch tensor: exact for the sweep's 36-720-point clouds,
out of reach at the 10k-100k points users embed.  This module is the
same algorithm on the kNN graph's edge list:

  * kNN: exact all-pairs top-k on the card, in true-f32 row blocks of
    8192 (tdax's ``jnp.dot(precision=HIGHEST)``: ``torch.matmul`` with
    TF32 off);
  * sigma/rho calibration and membership strengths on the [n, k] lists
    (fuzzy.py's functions);
  * the fuzzy symmetrization W = A + A^T - A o A^T on the host as a COO
    merge (numpy, deterministic, tdax's code verbatim);
  * the spectral init by block LOBPCG (lobpcg.py) on the deflated
    normalized adjacency, with segment-sum matvecs;
  * the SGD layout as a loop over epochs with per-edge sampling
    schedules and NEG_POOL shared negatives per point.

Random draws come from seeded ``torch.Generator``s, not tdax's
Threefry keys: the LOBPCG start, the init jitter and the PCA jitter
from a CPU generator (every device gets the same numbers), each
epoch's negatives from a generator on the device.  The private
keywords ``_x0`` (the LOBPCG start) and ``_negatives`` (a callable from
the epoch to a [rows, NEG_POOL] index tensor) let a caller inject
draws, as the tests inject tdax's.

Every sum over an edge list is a segmented sum over the sorted heads
(``torch.segment_reduce``): one thread per output element adds its
edges in order, so a run repeats bitwise on the card, where
``index_add_`` uses atomics.

With ``mesh=`` (tdax's mesh variants) the work splits over a process
group's ``axis`` in the idiom of ``tdax_torch.parallel.sharded_ops``:
each rank holds local tensors and takes its block by
``mesh.local_rank(axis)``, and results come back gathered in rank
order.  The kNN takes each rank's rows against the whole cloud in the
one-device block arithmetic; ``optimize_layout_edges_sharded`` gives
each rank a contiguous shard of the sorted edge list and sums the
per-point attraction table over the axis every epoch, the embedding
updating in lockstep; ``optimize_layout_edges_fixed_tail_sharded``
splits the new points, with no collective in the epoch loop.  Every
such call is collective: every rank of the group makes it with the
same arguments.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from tdax_torch.ops.umap.fuzzy import membership_strengths_knn, smooth_knn_dist
from tdax_torch.ops.umap.lobpcg import lobpcg_standard
from tdax_torch.parallel import mesh as pm
from tdax_torch.runtime import as_device_f32, get_device

NEG_POOL = 16
KNN_BLOCK_ROWS = 8192

# the seeded streams: (random_state, stream) -> one generator each
INIT_STREAM, LAYOUT_STREAM, TRANSFORM_STREAM = 0, 1, 2

#: per-stage wall clock of the latest embed_sparse call (host clock, each
#: stage ending in a synchronise), and the LOBPCG iteration count
#: ``init_iterations`` (0 under the PCA init)
LAST_TIMINGS: dict = {}


def _generator(random_state: int, stream: int, device) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(random_state), stream]).generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30)


def _block_knn(rows: torch.Tensor, full: torch.Tensor, sq_full, k: int, metric: str,
               row0: int | None, n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN of ``rows`` among ``full`` (cosine on normalized rows, clipped
    to [0, 2], or Euclidean in expansion form); with ``row0`` the first
    ``n_real`` rows are points row0.. of ``full``, whose self-distance is
    pinned to exactly 0 (the expansion form leaves cancellation residue
    there, and the calibration skips column 0 as the self entry) where
    that point exists: a padded row past ``full``'s last is not pinned."""
    d = rows @ full.T
    if metric == "cosine":
        d.neg_().add_(1.0).clamp_(0.0, 2.0)
    else:
        sq_r = (rows * rows).sum(1)
        d = (sq_r[:, None] + sq_full[None, :]).sub_(d.mul_(2.0)).clamp_min_(0.0).sqrt_()
    if row0 is not None:
        r = torch.arange(max(0, min(n_real, full.shape[0] - row0)), device=d.device)
        d[r, row0 + r] = 0.0
    dist, idx = torch.topk(d, k, dim=1, largest=False)
    return idx[:n_real], dist[:n_real]


def _knn(rows_all: torch.Tensor, full: torch.Tensor, k: int, metric: str, block_rows: int,
         row0: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Row blocks of ``block_rows``; the tail block is padded with the
    leading rows (tdax's fixed block shape) and their results dropped.
    ``row0``: the index in ``full`` of ``rows_all``'s first row (the self
    pin), None for a cross kNN."""
    n = rows_all.shape[0]
    sq_full = (full * full).sum(1) if metric != "cosine" else None
    if n <= block_rows:
        return _block_knn(rows_all, full, sq_full, k, metric, row0, n)
    idxs, dists = [], []
    for r0 in range(0, n, block_rows):
        hi = min(r0 + block_rows, n)
        pad = block_rows - (hi - r0)
        rows = torch.cat([rows_all[r0:hi], rows_all[:pad]]) if pad else rows_all[r0:hi]
        i, d = _block_knn(rows, full, sq_full, k, metric,
                          None if row0 is None else row0 + r0, hi - r0)
        idxs.append(i)
        dists.append(d)
    return torch.cat(idxs), torch.cat(dists)


def _knn_sharded(rows_all: torch.Tensor, full: torch.Tensor, k: int, metric: str,
                 block_rows: int, mesh, axis: str, self_pin: bool):
    """The rows split over ``axis``: rank r takes rows r*m .. (r+1)*m, m =
    ceil(n / p), the last share padded with copies of row 0 (tdax's
    padding), and runs ``_knn`` on them against the whole of ``full``;
    the shares are gathered in rank order and the padding sliced off.

    A share shorter than one device's block (min(n, block_rows) rows) is
    padded to it with more copies of row 0, so that every product has one
    device's row count: cuBLAS picks its kernel by the shape, and a
    500-row block of a 2000-row cross kNN rounds apart from the 2000-row
    product on an H100 (a 1000-row block does not).  A rank then does up
    to one device's block of work, and each row gets one device's bits."""
    n = rows_all.shape[0]
    m = math.ceil(n / mesh.shape[axis])
    width = max(m, min(n, block_rows))
    r0 = mesh.local_rank(axis) * m
    share = rows_all[r0:r0 + m]
    if share.shape[0] < width:
        share = torch.cat([share, rows_all[:1].expand(width - share.shape[0], -1)])
    idx, dist = _knn(share, full, k, metric, block_rows, r0 if self_pin else None)
    idx, dist = idx[:m].contiguous(), dist[:m].contiguous()
    return pm.all_gather(idx, mesh, axis)[:n], pm.all_gather(dist, mesh, axis)[:n]


def _check_metric(metric: str) -> None:
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unsupported metric {metric!r}")


def knn_blocked(x: torch.Tensor, k: int, metric: str, block_rows: int = KNN_BLOCK_ROWS,
                mesh=None, axis: str = "dp") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN lists of x [n, D] among themselves: (idx [n, k] int64,
    dist [n, k] f32), ascending, self first.  With ``mesh`` the rows
    split over ``axis`` (collective), each row's arithmetic and bits the
    one device's (``_knn_sharded``)."""
    _check_metric(metric)
    xn = _normalize_rows(x) if metric == "cosine" else x
    if mesh is not None:
        return _knn_sharded(xn, xn, k, metric, block_rows, mesh, axis, self_pin=True)
    return _knn(xn, xn, k, metric, block_rows, row0=0)


def knn_blocked_cross(x_new: torch.Tensor, x_train: torch.Tensor, k: int, metric: str,
                      block_rows: int = KNN_BLOCK_ROWS, mesh=None,
                      axis: str = "dp") -> tuple[torch.Tensor, torch.Tensor]:
    """kNN lists of x_new among x_train (idx [n_new, k], dist [n_new, k]);
    no self semantics: the two clouds are distinct.  With ``mesh`` the
    new points' rows split over ``axis`` (collective)."""
    _check_metric(metric)
    if metric == "cosine":
        x_new, x_train = _normalize_rows(x_new), _normalize_rows(x_train)
    if mesh is not None:
        return _knn_sharded(x_new, x_train, k, metric, block_rows, mesh, axis, self_pin=False)
    return _knn(x_new, x_train, k, metric, block_rows, row0=None)


def build_sym_edges(knn_idx: np.ndarray, w: np.ndarray, set_op_mix_ratio: float = 1.0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed membership lists -> symmetric COO edge list (host).

    Returns (head [E], tail [E], weight [E]) with BOTH directions of
    every undirected edge (umap's layout iterates all nonzeros of the
    symmetric matrix), weights W = mix*(A + A^T - A o A^T) + (1-mix)*A o A^T,
    self-loops and zero weights dropped, sorted by (head, tail).
    """
    n, k = knn_idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = knn_idx.reshape(-1).astype(np.int64)
    vals = np.asarray(w, dtype=np.float64).reshape(-1)
    keep = (rows != cols) & (vals > 0)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    # dedup duplicate directed entries (can happen with distance ties)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq = np.ones(len(key), dtype=bool)
    uniq[1:] = key[1:] != key[:-1]
    grp = np.cumsum(uniq) - 1
    a_val = np.zeros(int(grp[-1]) + 1 if len(grp) else 0)
    np.maximum.at(a_val, grp, vals)  # umap dedups by max on ties
    rows, cols = rows[uniq], cols[uniq]

    # A o A^T and A + A^T via key merge: transpose key = cols * n + rows
    key = rows * n + cols
    tkey = cols * n + rows
    pos = np.searchsorted(key, tkey)
    pos_clip = np.minimum(pos, len(key) - 1)
    has_t = key[pos_clip] == tkey
    at_val = np.where(has_t, a_val[pos_clip], 0.0)

    sym = set_op_mix_ratio * (a_val + at_val - a_val * at_val) \
        + (1.0 - set_op_mix_ratio) * (a_val * at_val)

    # every directed entry emits (rows, cols, sym), which covers both
    # directions of an edge that both endpoints list; the reverse of a
    # one-sided edge is emitted explicitly
    one_sided = ~has_t
    head = np.concatenate([rows, cols[one_sided]])
    tail = np.concatenate([cols, rows[one_sided]])
    wgt = np.concatenate([sym, sym[one_sided]])
    keep = wgt > 0
    head, tail, wgt = head[keep], tail[keep], wgt[keep]
    order = np.lexsort((tail, head))
    return (head[order].astype(np.int32), tail[order].astype(np.int32),
            wgt[order].astype(np.float32))


class _Segments:
    """Sums over an edge list sorted by head, one segment per point:
    ``torch.segment_reduce`` adds each segment's rows in order, one
    thread per output element, so the sums repeat bitwise on the card."""

    def __init__(self, head: torch.Tensor, n: int):
        if head.numel() > 1 and not bool((head[1:] >= head[:-1]).all()):
            raise ValueError("the edge list must be sorted by head")
        self.lengths = torch.bincount(head, minlength=n)

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(data, "sum", lengths=self.lengths, axis=0, unsafe=True)


def _normalized_adjacency(head, tail, w, n):
    """(segments, v0, coef): M = D^-1/2 W D^-1/2 as per-edge coefficients,
    and v0 = sqrt(deg) / |sqrt(deg)|, the Laplacian's trivial null vector."""
    seg = _Segments(head, n)
    deg = seg.sum(w)
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1e-12)), 0.0)
    v0 = torch.sqrt(deg.clamp_min(0.0))
    v0 = v0 / torch.linalg.vector_norm(v0).clamp_min(1e-12)
    coef = w * inv_sqrt[head] * inv_sqrt[tail]
    return seg, v0, coef


def _scaled_with_jitter(emb: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Scaled to max-abs 10, plus N(0, 1e-4) jitter drawn from ``gen`` on the CPU."""
    emb = emb * (emb.new_tensor(10.0) / emb.abs().max().clamp_min(1e-12))
    noise = torch.randn(tuple(emb.shape), generator=gen, dtype=torch.float32)
    return (emb + noise.to(emb.device) * 1e-4).to(torch.float32)


def _start(shape, gen, _x0, device) -> torch.Tensor:
    x0 = torch.randn(shape, generator=gen, dtype=torch.float32) if _x0 is None else _x0
    return torch.as_tensor(x0, dtype=torch.float32).to(device)


def spectral_init_edges(head: torch.Tensor, tail: torch.Tensor, w: torch.Tensor, n: int,
                        n_components: int, random_state: int, n_iter: int = 200, *,
                        _x0=None) -> torch.Tensor:
    """Bottom non-trivial eigenvectors of the normalized Laplacian by
    orthogonal iteration on M + I (segment-sum matvecs, the trivial
    eigenvector deflated), scaled to max-abs 10 with the 1e-4 jitter."""
    seg, v0, coef = _normalized_adjacency(head, tail, w, n)

    def matvec(v):
        return seg.sum(coef[:, None] * v[tail])

    def ortho(v):
        v = v - v0[:, None] * (v0 @ v)[None, :]
        return torch.linalg.qr(v).Q

    gen = _generator(random_state, INIT_STREAM, "cpu")
    v = ortho(_start((n, n_components), gen, _x0, w.device))
    for _ in range(n_iter):
        # the shift by +1 makes M + I positive, so M's largest dominate
        v = ortho(matvec(v) + v)
    # columns by M's Rayleigh quotient descending == Laplacian ascending
    rq = (v * matvec(v)).sum(0)
    v = v[:, torch.argsort(-rq)]
    return _scaled_with_jitter(v, gen)


def spectral_init_lobpcg(head: torch.Tensor, tail: torch.Tensor, w: torch.Tensor, n: int,
                         n_components: int, random_state: int, m: int = 400, *,
                         _x0=None) -> tuple[torch.Tensor, int]:
    """umap-learn's ``init='spectral'`` at scale: the bottom non-trivial
    eigenvectors of L = I - D^-1/2 W D^-1/2 of the symmetrized fuzzy
    graph, scaled to max-abs 10 with the 1e-4 jitter.  Returns (the init
    [n, n_components], LOBPCG's iteration count).

    LOBPCG takes the TOP eigenpairs of B = I + M - 2 v0 v0^T (M = D^-1/2
    W D^-1/2, v0 L's trivial null vector): eig(B) = 2 - eig(L) on v0's
    complement and the deflation maps the trivial pair to 0, so B's top
    n_components are L's bottom non-trivial in ascending order.  On a
    disconnected graph the remaining eigenvalue-2 vectors are component
    indicators, so components separate.  The block carries two guard
    vectors: the k-th Ritz vector converges with the gap to the
    (block+1)-th eigenvalue, and kNN graphs have near-degenerate pairs at
    the cut.

    Departure from tdax, which keeps JAX's default tolerance: a pair
    counts as converged at a residual below 10 sqrt(n) eps (|B x| +
    theta), the random-walk size of the rounding in B's n-term products,
    where JAX's default allows the worst case 10 n eps (|B x| + theta).
    That bound grows with n: at 100,000 points it passes every pair after
    one iteration and leaves the init near its random start.  On
    bench_umap.py's mixture at 100,000 x 64 on a CPU, tdax's init has a
    planted-cluster silhouette of -0.02 and its 200-epoch layout 0.49;
    under this rule the init takes 20 iterations and reads 0.74."""
    seg, v0, coef = _normalized_adjacency(head, tail, w, n)

    def bmat(vblock):
        mv = seg.sum(coef[:, None] * vblock[tail])
        return vblock + mv - 2.0 * v0[:, None] * (v0 @ vblock)[None, :]

    block = n_components + 2
    gen = _generator(random_state, INIT_STREAM, "cpu")
    x0 = _start((n, block), gen, _x0, w.device)
    x0 = x0 - v0[:, None] * (v0 @ x0)[None, :]
    tol = float(torch.finfo(torch.float32).eps) / math.sqrt(n)
    _, u, iterations = lobpcg_standard(bmat, x0, m=m, tol=tol)
    emb = u[:, :n_components]  # descending in B == Laplacian ascending
    return _scaled_with_jitter(emb, gen), iterations


def pca_init(x: torch.Tensor, n_components: int, random_state: int) -> torch.Tensor:
    """PCA init (``TDAX_UMAP_INIT=pca``), scaled to max-abs 10 with the
    1e-4 jitter: one [d, d] eigh, columns by variance descending."""
    xc = x - x.mean(0)
    _, vecs = torch.linalg.eigh(xc.T @ xc)  # ascending
    emb = xc @ vecs[:, -n_components:].flip(1)
    return _scaled_with_jitter(emb, _generator(random_state, INIT_STREAM, "cpu"))


def _f32(v) -> float:
    return float(np.float32(v))


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``torch.pow(x, e)`` whose value at an element does not depend on
    the length of the call.  On the CPU torch computes a call's last
    numel mod 32 elements in a scalar loop (``std::pow``) and the rest in
    a vector loop (SLEEF), which round apart by an ulp: padding the call
    to a multiple of 64 elements sends every element down the vector
    loop, so a rank's shard of an edge list or of the new points gets
    one device's bits.  A card's elementwise kernel has no such split."""
    if x.device.type != "cpu":
        return torch.pow(x, e)
    flat = x.reshape(-1)
    pad = -flat.numel() % 64
    return torch.pow(F.pad(flat, (0, pad), value=1.0), e)[:flat.numel()].reshape(x.shape)


def _schedules(w: torch.Tensor, n_epochs: int, negative_sample_rate: int, wmax=None):
    """(eps, epns, edge_on, eons, eonns): umap's epochs_per_sample after
    the wmax / n_epochs prune, true f32 divisions as tdax's.  ``wmax``:
    the whole edge list's largest weight where ``w`` is a shard of it
    (tdax's ``pmax``), else ``w``'s own."""
    wmax = w.max() if wmax is None else wmax
    w = torch.where(w < wmax / n_epochs, 0.0, w)
    n_samples = n_epochs * (w / wmax.clamp_min(1e-30))
    eps = torch.where(n_samples > 0, w.new_tensor(n_epochs) / n_samples.clamp_min(1e-30),
                      float("inf"))
    epns = eps / negative_sample_rate
    edge_on = torch.isfinite(eps)
    return (eps, epns, edge_on, torch.where(edge_on, eps, float("inf")),
            torch.where(edge_on, epns, float("inf")))


def _attraction(diff, active, a32, b32, eons_epoch_minus, epns):
    """(payload [E, d + 2]: clipped attraction | active | owed negatives,
    owed negatives [E]) for one epoch."""
    d2 = (diff * diff).sum(-1)
    d2c = d2.clamp_min(1e-12)
    pd2b = _pow(d2c, float(b32))
    att_coeff = torch.where(d2 > 0.0,
                            (_f32(np.float32(-2.0) * a32 * b32) * pd2b / d2c)
                            / (float(a32) * pd2b + 1.0), 0.0)
    att = (att_coeff[:, None] * diff).clamp(-4.0, 4.0)
    att = torch.where(active[:, None], att, 0.0)
    n_neg = torch.where(active, eons_epoch_minus / epns, 0.0).floor()
    payload = torch.cat([att, active.to(att.dtype)[:, None], n_neg[:, None]], 1)
    return payload, n_neg


def _repulsion(emb, en, a32, b32, g32):
    """Clipped repulsive gradients [rows, NEG_POOL, d] and the squared distances."""
    ndiff = emb[:, None, :] - en
    nd2 = (ndiff * ndiff).sum(-1)
    npd2b = _pow(nd2.clamp_min(1e-12), float(b32))
    num = nd2.new_tensor(_f32(np.float32(2.0) * g32 * b32))
    rep_coeff = num / ((0.001 + nd2) * (float(a32) * npd2b + 1.0))
    return (rep_coeff[..., None] * ndiff).clamp(-4.0, 4.0), nd2


def _alpha(initial_alpha: float, epoch: int, n_epochs: int) -> float:
    return float(np.float32(initial_alpha)
                 * (np.float32(1.0) - np.float32(epoch) / np.float32(n_epochs)))


def _negative_draws(_negatives, gen, rows: int, high: int, device):
    if _negatives is not None:
        return lambda epoch: torch.as_tensor(_negatives(epoch)).to(device, torch.int64)
    return lambda epoch: torch.randint(0, high, (rows, NEG_POOL), generator=gen, device=device)


def _layout_edges(init, head, tail, w, n, n_epochs, random_state, a, b, gamma, initial_alpha,
                  negative_sample_rate, _negatives, wmax=None, total=None) -> torch.Tensor:
    """The epoch loop of ``optimize_layout_edges`` on ``head``/``tail``/``w``
    (the whole list, or a rank's shard of it with the whole list's
    ``wmax``); ``total`` sums a shard's per-point table over the ranks."""
    a32, b32, g32 = np.float32(a), np.float32(b), np.float32(gamma)
    device = init.device
    eps, epns, edge_on, eons, eonns = _schedules(w, n_epochs, negative_sample_rate, wmax)
    seg = _Segments(head, n)
    self_ix = torch.arange(n, device=device)[:, None]
    draw = _negative_draws(_negatives, _generator(random_state, LAYOUT_STREAM, device), n, n,
                           device)
    emb = init.to(torch.float32)
    for epoch in range(n_epochs):
        alpha = _alpha(initial_alpha, epoch, n_epochs)
        active = edge_on & (eons <= float(epoch))
        payload, n_neg = _attraction(emb[head] - emb[tail], active, a32, b32,
                                     float(epoch) - eonns, epns)
        s = seg.sum(payload)
        if total is not None:
            s = total(s)
        force = 2.0 * s[:, :-2]
        cnt = 2.0 * s[:, -2]
        owed = s[:, -1]

        ridx = draw(epoch)
        rep, nd2 = _repulsion(emb, emb[ridx], a32, b32, g32)
        zero_d = nd2 <= 0.0
        is_self = ridx == self_ix
        rep = torch.where((zero_d & ~is_self)[..., None], 4.0, rep)
        on = ~(zero_d & is_self)
        rep = torch.where(on[..., None], rep, 0.0)
        scale = owed / NEG_POOL
        force = force + rep.sum(1) * scale[:, None]
        cnt = cnt + on.sum(1).to(torch.float32) * scale

        emb = emb + force / cnt.clamp_min(1.0)[:, None] * alpha
        eons = torch.where(active, eons + eps, eons)
        eonns = torch.where(active, eonns + n_neg * epns, eonns)
    return emb


def optimize_layout_edges(init: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                          w: torch.Tensor, n: int, n_epochs: int, random_state: int,
                          a: float, b: float, gamma: float = 1.0, initial_alpha: float = 1.0,
                          negative_sample_rate: int = 5, *, _negatives=None) -> torch.Tensor:
    """layout.py's epoch-synchronous SGD on a SYMMETRIC edge list (both
    directions of every edge, equal weights: what build_sym_edges emits).

    Per-edge epochs_per_sample schedules; attraction -2ab d^(2b-2) /
    (1 + a d^2b) clipped to [-4, 4], the tails' recoil being exactly
    minus the mirror edge's attraction, so the head segment sum doubled
    is the whole attraction.  Negatives per POINT: each epoch every
    point draws NEG_POOL uniform points, and its repulsion 2 gamma b /
    ((0.001 + d^2)(1 + a d^2b)) (clipped; +4 at zero distance; a
    zero-distance draw of itself skipped) is the pool's mean scaled by
    the negatives its edges owe.  One mean-force update an epoch, alpha
    falling linearly to 0."""
    return _layout_edges(init, head, tail, w, n, n_epochs, random_state, a, b, gamma,
                         initial_alpha, negative_sample_rate, _negatives)


def optimize_layout_edges_sharded(init: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                                  w: torch.Tensor, n: int, n_epochs: int, random_state: int,
                                  a: float, b: float, mesh, axis: str = "dp",
                                  gamma: float = 1.0, initial_alpha: float = 1.0,
                                  negative_sample_rate: int = 5, *,
                                  _negatives=None) -> torch.Tensor:
    """``optimize_layout_edges`` with the EDGES split over ``axis``
    (collective): rank r owns the r-th contiguous shard of the sorted
    list, its schedule state with it, and each epoch sums its shard's
    [n, d + 2] attraction table (``_Segments.sum``) over the axis with
    one ``all_reduce``; the repulsion and the update run on the whole
    embedding on every rank in lockstep, every rank drawing the same
    negatives (the same seeded generator on the same device type).

    The schedule normalizer is the whole list's largest weight (tdax's
    ``pmax``).  The list is padded to a multiple of the axis size with
    weight-0 edges on its last head, which keeps each shard sorted (tdax
    pads with head 0; ``_Segments`` needs sorted heads) and which the
    wmax / n_epochs cut keeps inactive.  Only the points whose edges
    straddle a shard boundary add in another order than one device's;
    with one rank there is no pad and the layout is one device's."""
    p = mesh.shape[axis]
    e = head.shape[0]
    per = math.ceil(e / p)
    pad = per * p - e
    wmax = w.max()
    if pad:
        head = torch.cat([head, head[-1:].expand(pad)])
        tail = torch.cat([tail, head[-1:].expand(pad)])
        w = torch.cat([w, w.new_zeros(pad)])
    sl = slice(mesh.local_rank(axis) * per, (mesh.local_rank(axis) + 1) * per)
    return _layout_edges(init, head[sl], tail[sl], w[sl], n, n_epochs, random_state, a, b,
                         gamma, initial_alpha, negative_sample_rate, _negatives, wmax=wmax,
                         total=lambda s: pm.all_reduce(s, mesh, axis))


def _layout_fixed_tail(init, tail_emb, head, tail, w, n_epochs, a, b, gamma, initial_alpha,
                       negative_sample_rate, draw, wmax=None) -> torch.Tensor:
    """The epoch loop of ``optimize_layout_edges_fixed_tail`` for the new
    points ``init`` (their edges' heads 0 ..), negatives from ``draw``."""
    a32, b32, g32 = np.float32(a), np.float32(b), np.float32(gamma)
    tail_fixed = tail_emb.to(torch.float32)
    eps, epns, edge_on, eons, eonns = _schedules(w, n_epochs, negative_sample_rate, wmax)
    seg = _Segments(head, init.shape[0])
    emb = init.to(torch.float32)
    for epoch in range(n_epochs):
        alpha = _alpha(initial_alpha, epoch, n_epochs)
        active = edge_on & (eons <= float(epoch))
        payload, n_neg = _attraction(emb[head] - tail_fixed[tail], active, a32, b32,
                                     float(epoch) - eonns, epns)
        s = seg.sum(payload)
        force, cnt, owed = s[:, :-2], s[:, -2], s[:, -1]

        rep, nd2 = _repulsion(emb, tail_fixed[draw(epoch)], a32, b32, g32)
        rep = torch.where((nd2 <= 0.0)[..., None], 4.0, rep)
        force = force + rep.sum(1) * (owed / NEG_POOL)[:, None]
        cnt = cnt + owed

        emb = emb + force / cnt.clamp_min(1.0)[:, None] * alpha
        eons = torch.where(active, eons + eps, eons)
        eonns = torch.where(active, eonns + n_neg * epns, eonns)
    return emb


def optimize_layout_edges_fixed_tail(init: torch.Tensor, tail_emb: torch.Tensor,
                                     head: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                                     n_epochs: int, random_state: int, a: float, b: float,
                                     gamma: float = 1.0, initial_alpha: float = 1.0,
                                     negative_sample_rate: int = 5, *,
                                     _negatives=None) -> torch.Tensor:
    """optimize_layout_edges in transform mode: the tails stay at
    ``tail_emb`` (the fitted embedding), only the heads (new points)
    move, and each new point's NEG_POOL negatives are train points.
    Every zero-distance draw takes the +4 kick (no tail to exempt)."""
    device = init.device
    draw = _negative_draws(_negatives, _generator(random_state, TRANSFORM_STREAM, device),
                           init.shape[0], tail_emb.shape[0], device)
    return _layout_fixed_tail(init, tail_emb, head, tail, w, n_epochs, a, b, gamma,
                              initial_alpha, negative_sample_rate, draw)


def optimize_layout_edges_fixed_tail_sharded(init: torch.Tensor, tail_emb: torch.Tensor,
                                             head: torch.Tensor, tail: torch.Tensor,
                                             w: torch.Tensor, n_epochs: int, random_state: int,
                                             a: float, b: float, mesh, axis: str = "dp",
                                             gamma: float = 1.0, initial_alpha: float = 1.0,
                                             negative_sample_rate: int = 5, *,
                                             _negatives=None) -> torch.Tensor:
    """The transform layout with the NEW POINTS split over ``axis``
    (collective): the tails are fixed, so each new point moves on its
    own; rank r embeds rows r*m .. (r+1)*m (m = ceil(n_new / p)) against
    the whole train embedding with no collective in the epoch loop, and
    the rows are gathered in rank order.  The negatives are drawn in
    their one-device shape and sliced to the rank's rows, and the
    schedule normalizer is the whole list's, so the result is the one
    device's bit for bit.  Needs the transform's edge layout (k edges a
    new point, heads contiguous: what ``transform_sparse`` builds); the
    padded rows (zero init, k weight-0 edges on tail 0) are dropped."""
    n_new, dim = init.shape
    e = head.shape[0]
    if e % n_new:
        raise ValueError(f"fixed-tail sharding needs k edges a new point: {e} edges, "
                         f"{n_new} points")
    k = e // n_new
    m = math.ceil(n_new / mesh.shape[axis])
    pad = m * mesh.shape[axis] - n_new
    wmax = w.max()
    if pad:
        init = torch.cat([init, init.new_zeros(pad, dim)])
        head = torch.cat([head, torch.arange(n_new, n_new + pad, device=head.device,
                                             dtype=head.dtype).repeat_interleave(k)])
        tail = torch.cat([tail, tail.new_zeros(pad * k)])
        w = torch.cat([w, w.new_zeros(pad * k)])
    row0 = mesh.local_rank(axis) * m
    device = init.device
    one_device = _negative_draws(_negatives, _generator(random_state, TRANSFORM_STREAM, device),
                                 n_new, tail_emb.shape[0], device)

    def draw(epoch):
        ridx = one_device(epoch)
        if pad:
            ridx = torch.cat([ridx, ridx.new_zeros(pad, NEG_POOL)])
        return ridx[row0:row0 + m]

    edges = slice(row0 * k, (row0 + m) * k)
    emb = _layout_fixed_tail(init[row0:row0 + m], tail_emb, head[edges] - row0, tail[edges],
                             w[edges], n_epochs, a, b, gamma, initial_alpha,
                             negative_sample_rate, draw, wmax=wmax)
    return pm.all_gather(emb, mesh, axis)[:n_new]


def transform_sparse(x_new, train_x: torch.Tensor, train_emb, n_neighbors: int, metric: str,
                     n_epochs: int, random_state: int, a: float, b: float,
                     learning_rate: float, negative_sample_rate: int,
                     repulsion_strength: float, local_connectivity: float, mesh=None, *,
                     _negatives=None) -> np.ndarray:
    """Embed new points against a fitted reducer on the edge list
    (umap.UMAP.transform: cross-kNN calibration, weighted-mean init,
    fixed-tail SGD at alpha/4), on train_x's device.  With ``mesh`` the
    new points split over its ``"dp"`` axis for the kNN and the layout
    (collective); the result is the one device's."""
    device = train_x.device
    get_device(device)  # the precision switches (TF32 off), for tensors passed in too
    xj = as_device_f32(x_new, device)
    n_new, k = xj.shape[0], n_neighbors
    idx, dists = knn_blocked_cross(xj, train_x, k, metric, mesh=mesh)

    # no self column in a cross-kNN: a zero column keeps the
    # calibration's skip-self convention (as the dense transform)
    sigma, rho = smooth_knn_dist(torch.cat([torch.zeros_like(dists[:, :1]), dists], 1),
                                 float(k), local_connectivity=local_connectivity)
    d_adj = dists - rho[:, None]
    w = torch.where(d_adj <= 0.0, 1.0, torch.exp(-d_adj / sigma[:, None]))

    head = torch.arange(n_new, device=device).repeat_interleave(k)
    emb_t = torch.as_tensor(train_emb, dtype=torch.float32).to(device)
    # init: the weighted mean of the neighbours' embeddings
    wsum = w.sum(1).clamp_min(1e-12)
    init = (w[:, :, None] * emb_t[idx]).sum(1) / wsum[:, None]
    kw = dict(gamma=repulsion_strength, initial_alpha=learning_rate / 4.0,
              negative_sample_rate=negative_sample_rate, _negatives=_negatives)
    edges = (head, idx.reshape(-1), w.reshape(-1), n_epochs, random_state, a, b)
    if mesh is not None:
        emb = optimize_layout_edges_fixed_tail_sharded(init, emb_t, *edges, mesh, **kw)
    else:
        emb = optimize_layout_edges_fixed_tail(init, emb_t, *edges, **kw)
    return emb.cpu().numpy()


def embed_sparse(x, n_neighbors: int, n_components: int, metric: str, n_epochs: int,
                 random_state: int, a: float, b: float, learning_rate: float,
                 negative_sample_rate: int, repulsion_strength: float,
                 local_connectivity: float, set_op_mix_ratio: float, device=None,
                 mesh=None, *, _x0=None, _negatives=None) -> np.ndarray:
    """One large cloud -> its [n, n_components] embedding on the edge
    list, on the card unless ``device="cpu"`` (a tensor stays where it
    lies).  With ``mesh`` the kNN rows and the layout's edges split over
    its ``"dp"`` axis (collective); the COO merge and the spectral init
    run on every rank on the gathered lists, as in tdax.  Stage times
    land in ``LAST_TIMINGS``."""
    t = {}
    t0 = time.perf_counter()
    xj = as_device_f32(x, device)
    dev = get_device(xj.device)  # the precision switches (TF32 off), for a tensor passed in too
    _sync(dev)
    t["upload_s"] = time.perf_counter() - t0
    n = xj.shape[0]

    t0 = time.perf_counter()
    idx, dists = knn_blocked(xj, n_neighbors, metric, mesh=mesh)
    sigma, rho = smooth_knn_dist(dists, float(n_neighbors), local_connectivity=local_connectivity)
    w_knn = membership_strengths_knn(idx, dists, sigma, rho)
    idx_h, w_h = idx.cpu().numpy(), w_knn.cpu().numpy()
    t["knn_calib_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    head, tail, wgt = (torch.as_tensor(v).to(dev) for v in build_sym_edges(
        idx_h, w_h, set_op_mix_ratio))
    head, tail = head.long(), tail.long()
    t["sym_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # umap-learn's default init='spectral' (the reference runs umap's
    # defaults, debug_tda_pipeline.py:96-102); TDAX_UMAP_INIT=pca keeps
    # the cheaper PCA init, as in tdax
    if os.environ.get("TDAX_UMAP_INIT") == "pca":
        init, iterations = pca_init(xj, n_components, random_state), 0
    else:
        init, iterations = spectral_init_lobpcg(head, tail, wgt, n, n_components,
                                                random_state, _x0=_x0)
    _sync(dev)
    t["init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kw = dict(gamma=repulsion_strength, initial_alpha=learning_rate,
              negative_sample_rate=negative_sample_rate, _negatives=_negatives)
    edges = (init, head, tail, wgt, n, n_epochs, random_state, a, b)
    if mesh is not None:
        emb = optimize_layout_edges_sharded(*edges, mesh, **kw)
    else:
        emb = optimize_layout_edges(*edges, **kw)
    out = emb.cpu().numpy()
    t["layout_s"] = time.perf_counter() - t0
    t["init_iterations"] = iterations
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(t)
    return out
