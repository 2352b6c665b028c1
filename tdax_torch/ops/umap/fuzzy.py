"""kNN graph + fuzzy simplicial set (port of ``tdax/ops/umap/fuzzy.py``).

umap-learn's ``nearest_neighbors`` / ``smooth_knn_dist`` /
``compute_membership_strengths`` / ``fuzzy_simplicial_set`` as the
reference uses them (debug_tda_pipeline.py:96-104): k counts the point
itself as its first neighbour (distance 0), target entropy log2(k), a
64-step bisection for sigma, rho from ``local_connectivity``, and the
symmetrization W = A + A^T - A o A^T (set_op_mix_ratio = 1).

Every function takes a leading batch of clouds (``[..., n, ...]``), so
the 32-layer sweep builds all its graphs in one set of calls.  kNN is an
exact all-pairs top-k and the fuzzy graph is dense [n, n].
"""

from __future__ import annotations

import math

import torch

from tdax_torch.ops.distances import pairwise_cosine, pairwise_euclidean

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def pairwise(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return pairwise_cosine(x)
    if metric == "euclidean":
        return pairwise_euclidean(x)
    raise ValueError(f"unsupported metric {metric!r}")


def knn(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices [..., n, k], distances [..., n, k]) ascending; self first (d = 0)."""
    neg, idx = torch.topk(-dist, k, dim=-1)
    return idx, -neg


def smooth_knn_dist(knn_dists: torch.Tensor, k: float, local_connectivity: float = 1.0,
                    bandwidth: float = 1.0, n_iter: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point (sigma, rho): bisection to hit log2(k) entropy."""
    target = math.log2(k) * bandwidth
    inf = float("inf")

    # rho: interpolated local_connectivity-th smallest NONZERO distance
    nonzero = torch.where(knn_dists > 0.0, knn_dists, inf)
    nonzero_sorted = nonzero.sort(dim=-1).values
    n_nonzero = (knn_dists > 0.0).sum(-1)
    index = int(math.floor(local_connectivity))
    interpolation = local_connectivity - index
    if index > 0:
        lo = nonzero_sorted[..., index - 1]
        if interpolation > SMOOTH_K_TOLERANCE:
            # umap interpolates only for a non-negligible fraction; the upper
            # neighbour is inf when too few nonzero distances exist
            hi = nonzero_sorted[..., min(index, knn_dists.shape[-1] - 1)]
            hi = torch.where(torch.isfinite(hi), hi, lo)
            rho_interp = lo + interpolation * (hi - lo)
        else:
            rho_interp = lo
    else:
        rho_interp = interpolation * nonzero_sorted[..., 0]
    finite_max = torch.where(torch.isfinite(nonzero), nonzero, 0.0).amax(-1)
    rho_max = torch.where(n_nonzero > 0, finite_max, 0.0)
    rho = torch.where(n_nonzero >= local_connectivity, rho_interp, rho_max)
    rho = torch.where(n_nonzero > 0, rho, 0.0)
    rho = torch.where(torch.isfinite(rho), rho, 0.0)

    # bisection for sigma (umap: lo = 0, hi = inf, mid = 1); self at column 0 skipped
    d_adj = knn_dists[..., 1:] - rho[..., None]
    lo = torch.zeros_like(rho)
    hi = torch.full_like(rho, inf)
    mid = torch.ones_like(rho)
    for _ in range(n_iter):
        p = torch.where(d_adj > 0, torch.exp(-d_adj / mid[..., None]), 1.0).sum(-1)
        above = p > target
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
        mid = torch.where(torch.isinf(hi), mid * 2.0, (lo + hi) / 2.0)
    sigma = mid

    # lower bounds (umap's MIN_K_DIST_SCALE clamps)
    mean_i = knn_dists.mean(-1)
    mean_all = knn_dists.mean((-2, -1))[..., None]
    sigma = torch.where(rho > 0.0,
                        torch.maximum(sigma, MIN_K_DIST_SCALE * mean_i),
                        torch.maximum(sigma, MIN_K_DIST_SCALE * mean_all))
    return sigma, rho


def _memberships(knn_dists, sigma, rho) -> torch.Tensor:
    d_adj = knn_dists - rho[..., None]
    return torch.where(d_adj <= 0.0, 1.0, torch.exp(-d_adj / sigma[..., None]))


def membership_strengths_knn(knn_idx: torch.Tensor, knn_dists: torch.Tensor,
                             sigma: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Directed membership weights on the kNN lists themselves [..., n, k]
    (self entries zero): the edge-list path's counterpart of
    ``membership_strengths``, which scatters into a dense [n, n]."""
    n = knn_idx.shape[-2]
    w = _memberships(knn_dists, sigma, rho)
    rows = torch.arange(n, device=knn_idx.device)[:, None]
    return torch.where(knn_idx == rows, 0.0, w)


def membership_strengths(knn_idx: torch.Tensor, knn_dists: torch.Tensor,
                         sigma: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Dense directed membership matrix A[..., i, j] (self edges zero)."""
    n = knn_idx.shape[-2]
    w = _memberships(knn_dists, sigma, rho)
    rows = torch.arange(n, device=knn_idx.device)[:, None]
    w = torch.where(knn_idx == rows, 0.0, w)
    a = torch.zeros((*knn_idx.shape[:-1], n), dtype=w.dtype, device=w.device)
    return a.scatter_add_(-1, knn_idx, w)


def fuzzy_simplicial_set(x: torch.Tensor, n_neighbors: int, metric: str = "cosine",
                         local_connectivity: float = 1.0,
                         set_op_mix_ratio: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., n, D] -> (W [..., n, n] symmetric fuzzy graph, sigma, rho)."""
    idx, dists = knn(pairwise(x, metric), n_neighbors)
    sigma, rho = smooth_knn_dist(dists, float(n_neighbors),
                                 local_connectivity=local_connectivity)
    a = membership_strengths(idx, dists, sigma, rho)
    t = a.transpose(-1, -2)
    prod = a * t
    w = set_op_mix_ratio * (a + t - prod) + (1.0 - set_op_mix_ratio) * prod
    return w, sigma, rho
