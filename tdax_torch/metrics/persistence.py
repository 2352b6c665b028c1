"""Persistence-diagram summary metrics (port of ``tdax/metrics/persistence.py``).

``get_persistence`` mirrors the reference's helper
(debug_tda_pipeline.py:79-89): finite lifetimes and their max.
``diagram_stats`` builds the reference's per-layer stats dict, keys in
its order (debug_tda_pipeline.py:121-130).  ``bottleneck_distance`` is
the persim-contract metric: exact bottleneck by binary search over the
candidate costs with a bipartite-matching feasibility test, host numpy.
The sparse variant for diagrams past 2048 bars and the Wasserstein
distance come with the sparse slice.
"""

from __future__ import annotations

import numpy as np


def get_persistence(dgm: np.ndarray) -> tuple[np.ndarray, float]:
    """(finite lifetimes, max lifetime) — reference debug_tda_pipeline.py:79-89."""
    dgm = np.asarray(dgm).reshape(-1, 2)
    if dgm.shape[0] == 0:
        return np.array([]), 0.0
    pers = dgm[:, 1] - dgm[:, 0]
    pers = pers[np.isfinite(pers)]
    if pers.shape[0] == 0:
        return np.array([]), 0.0
    return pers, float(np.max(pers))


def diagram_stats(dgms: list[np.ndarray], layer: int | None = None) -> dict:
    """Per-layer stats dict with the reference's exact key schema."""
    h0, h1 = dgms[0], dgms[1] if len(dgms) > 1 else np.zeros((0, 2))
    h0_pers, max_h0 = get_persistence(h0)
    h1_pers, max_h1 = get_persistence(h1)
    stats = {
        "n_h1_features": int(len(h1_pers)),
        "max_h1_persistence": float(max_h1),
        "all_h1_persistence_values": [float(v) for v in h1_pers],
        "n_h0_features": int(len(h0) - len(h0_pers)),  # infinite bars
        "max_h0_persistence": float(max_h0),
    }
    if layer is not None:
        stats = {"layer": int(layer), **stats}
    return stats


def _feasible(cost: np.ndarray, eps: float) -> bool:
    """Is there a perfect matching using only edges with cost <= eps?
    Augmenting paths on the boolean graph."""
    n, m = cost.shape
    adj = cost <= eps
    match_l = np.full(n, -1)
    match_r = np.full(m, -1)

    def try_augment(u: int, seen: np.ndarray) -> bool:
        for v in np.flatnonzero(adj[u]):
            if seen[v]:
                continue
            seen[v] = True
            if match_r[v] == -1 or try_augment(match_r[v], seen):
                match_l[u] = v
                match_r[v] = u
                return True
        return False

    return all(try_augment(u, np.zeros(m, dtype=bool)) for u in range(n))


def bottleneck_distance(dgm_a: np.ndarray, dgm_b: np.ndarray) -> float:
    """Exact bottleneck distance between two diagrams (L-inf ground metric,
    points matchable to the diagonal).  Infinite-death points must match
    each other by sorted birth (else the distance is inf)."""
    a = np.asarray(dgm_a, dtype=np.float64).reshape(-1, 2)
    b = np.asarray(dgm_b, dtype=np.float64).reshape(-1, 2)
    if len(a) + len(b) > 2048:
        raise NotImplementedError(
            f"bottleneck distance of {len(a)} + {len(b)} bars needs the sparse "
            f"bottleneck path, which comes to the port with the sparse scale slice")

    a_inf, b_inf = a[np.isinf(a[:, 1])], b[np.isinf(b[:, 1])]
    a, b = a[np.isfinite(a[:, 1])], b[np.isfinite(b[:, 1])]
    inf_cost = 0.0
    if len(a_inf) or len(b_inf):
        if len(a_inf) != len(b_inf):
            return float("inf")
        inf_cost = float(np.max(np.abs(np.sort(a_inf[:, 0]) - np.sort(b_inf[:, 0]))))

    n, m = len(a), len(b)
    if n == 0 and m == 0:
        return inf_cost

    # augmented bipartite problem: each point may match the diagonal
    size = n + m
    cost = np.full((size, size), np.inf)
    if n and m:
        cost[:n, :m] = np.max(np.abs(a[:, None, :] - b[None, :, :]), axis=-1)
    cost[np.arange(n), m + np.arange(n)] = (a[:, 1] - a[:, 0]) / 2.0
    cost[n + np.arange(m), np.arange(m)] = (b[:, 1] - b[:, 0]) / 2.0
    cost[n:, m:] = 0.0  # diagonal-to-diagonal is free

    candidates = np.unique(cost[np.isfinite(cost)])
    lo, hi = 0, len(candidates) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if _feasible(cost, candidates[mid]):
            hi = mid
        else:
            lo = mid + 1
    return max(float(candidates[lo]), inf_cost)
