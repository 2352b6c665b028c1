"""Persistence-diagram summary metrics (port of ``tdax/metrics/persistence.py``).

``get_persistence`` mirrors the reference's helper
(debug_tda_pipeline.py:79-89): finite lifetimes and their max.
``diagram_stats`` builds the reference's per-layer stats dict, keys in
its order (debug_tda_pipeline.py:121-130).  ``bottleneck_distance`` is
the persim-contract metric: exact bottleneck by binary search over the
candidate costs with a bipartite-matching feasibility test, host numpy;
past 2048 bars it dispatches to ``bottleneck_distance_sparse`` (the same
exactly realized cost from windowed neighbour search and one-sided
Hopcroft-Karp, never an (n + m)^2 matrix).  ``wasserstein_distance`` is
the exact q-Wasserstein distance by optimal assignment (scipy), host
numpy.
"""

from __future__ import annotations

from collections import deque

import numpy as np

# candidate pairs the sparse bottleneck's exact finish holds at once
FINISH_CHUNK_PAIRS = 1 << 22


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
    each other by sorted birth (else the distance is inf).  Past 2048
    bars in all, ``bottleneck_distance_sparse`` answers."""
    a = np.asarray(dgm_a, dtype=np.float64).reshape(-1, 2)
    b = np.asarray(dgm_b, dtype=np.float64).reshape(-1, 2)
    if len(a) + len(b) > 2048:
        return bottleneck_distance_sparse(a, b)

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


# --- bottleneck at scale ----------------------------------------------------------
#
# feasibility(eps), "is the bottleneck <= eps", holds iff the bipartite
# graph {(a, b): Linf(a, b) <= eps} has a matching saturating
# A' = {a: pers_a > 2 eps} and one saturating B' = {b: pers_b > 2 eps}
# (everything else pairs with the diagonal for free; Mendelsohn-Dulmage
# joins the two one-sided matchings).  Candidates come from sorted
# searchsorted windows (_pairs_within), so a check costs the required
# bars times their eps-window neighbours, never n * m.  The search
# bisects numerically on [lower bound, max pers / 2] until the window's
# realized costs are few, then bisects over those: the answer is an
# exactly realized cost, as the dense path's.

def _pairs_within(pts_a: np.ndarray, pts_b: np.ndarray, eps: float):
    """(ai, bj) index arrays of every pair with Linf <= eps: searchsorted
    windows on the coordinate along which b spreads more (H0 diagrams
    have all births 0, where a birth window is all pairs), then the exact
    check on both coordinates."""
    ax = int(np.argmax(np.ptp(pts_b, axis=0))) if len(pts_b) else 0
    order = np.argsort(pts_b[:, ax], kind="stable")
    coord = pts_b[order, ax]
    lo = np.searchsorted(coord, pts_a[:, ax] - eps, side="left")
    hi = np.searchsorted(coord, pts_a[:, ax] + eps, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    ai = np.repeat(np.arange(len(pts_a)), counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    bj = order[np.repeat(lo, counts) + within]
    keep = np.abs(pts_b[bj, 1] - pts_a[ai, 1]) <= eps
    keep &= np.abs(pts_b[bj, 0] - pts_a[ai, 0]) <= eps
    return ai[keep], bj[keep]


def _hk_saturates(adj: list[list[int]], n_right: int) -> bool:
    """Hopcroft-Karp with an iterative DFS; True iff a matching saturates
    every left vertex."""
    inf = float("inf")
    n_left = len(adj)
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    dist = [0.0] * n_left

    def bfs() -> bool:
        q = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0.0
                q.append(u)
            else:
                dist[u] = inf
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found = True
                elif dist[w] == inf:
                    dist[w] = dist[u] + 1
                    q.append(w)
        return found

    def dfs(root: int) -> bool:
        stack = [(root, iter(adj[root]))]
        path = []
        while stack:
            u, it = stack[-1]
            advanced = False
            for v in it:
                w = match_r[v]
                if w == -1:
                    path.append((u, v))
                    for uu, vv in path:
                        match_l[uu] = vv
                        match_r[vv] = uu
                    for uu, _ in stack:
                        dist[uu] = inf
                    return True
                if dist[w] == dist[u] + 1:
                    path.append((u, v))
                    stack.append((w, iter(adj[w])))
                    advanced = True
                    break
            if not advanced:
                dist[u] = inf
                stack.pop()
                if path:  # the edge that led into u (the root has none)
                    path.pop()
        return False

    matched = 0
    while bfs():
        for u in range(n_left):
            if match_l[u] == -1 and dfs(u):
                matched += 1
    return matched == n_left


def _side_saturable(req_pts: np.ndarray, other: np.ndarray, eps: float) -> bool:
    """Can every required point match a distinct other-side point within
    Linf eps?"""
    if len(req_pts) == 0:
        return True
    if len(other) == 0:
        return False
    ai, bj = _pairs_within(req_pts, other, eps)
    deg = np.bincount(ai, minlength=len(req_pts))
    if (deg == 0).any():
        return False
    uniq, bj_c = np.unique(bj, return_inverse=True)
    order = np.argsort(ai, kind="stable")
    adj = [c.tolist() for c in np.split(bj_c[order], np.cumsum(deg)[:-1])]
    return _hk_saturates(adj, len(uniq))


def _bn_feasible(a: np.ndarray, b: np.ndarray, pa: np.ndarray, pb: np.ndarray,
                 eps: float) -> bool:
    return (_side_saturable(a[pa > 2.0 * eps], b, eps)
            and _side_saturable(b[pb > 2.0 * eps], a, eps))


def _pair_costs_in_window(a: np.ndarray, b: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The Linf costs in (lo, hi] of every (a, b) pair, gathered over
    chunks of a's rows so that at most ~``FINISH_CHUNK_PAIRS`` window
    candidates (or one row's) are held at once."""
    ax = int(np.argmax(np.ptp(b, axis=0)))
    coord = np.sort(b[:, ax])
    per_row = (np.searchsorted(coord, a[:, ax] + hi, side="right")
               - np.searchsorted(coord, a[:, ax] - hi, side="left"))
    ends = np.cumsum(per_row)
    parts, start = [], 0
    while start < len(a):
        base = ends[start - 1] if start else 0
        stop = max(int(np.searchsorted(ends, base + FINISH_CHUNK_PAIRS, side="right")),
                   start + 1)
        ai, bj = _pairs_within(a[start:stop], b, hi)
        d = np.max(np.abs(a[start:stop][ai] - b[bj]), axis=1)
        parts.append(d[(d > lo) & (d <= hi)])
        start = stop
    return np.concatenate(parts)


def bottleneck_distance_sparse(dgm_a: np.ndarray, dgm_b: np.ndarray,
                               rel_tol: float = 1e-12) -> float:
    """Bottleneck distance of LARGE diagrams (10k+ bars), by windowed
    candidate search and one-sided Hopcroft-Karp feasibility (see the
    block comment above).  Returns an exactly realized cost, the dense
    path's answer.  Infinite-death bars pair across the diagrams by
    sorted birth; unequal counts give inf."""
    from scipy.spatial import cKDTree

    a = np.asarray(dgm_a, dtype=np.float64).reshape(-1, 2)
    b = np.asarray(dgm_b, dtype=np.float64).reshape(-1, 2)

    a_inf, b_inf = a[np.isinf(a[:, 1])], b[np.isinf(b[:, 1])]
    a, b = a[np.isfinite(a[:, 1])], b[np.isfinite(b[:, 1])]
    if len(a_inf) != len(b_inf):
        return float("inf")
    inf_cost = float(np.max(np.abs(np.sort(a_inf[:, 0]) - np.sort(b_inf[:, 0])))) \
        if len(a_inf) else 0.0
    if len(a) == 0 and len(b) == 0:
        return inf_cost

    pa = a[:, 1] - a[:, 0]
    pb = b[:, 1] - b[:, 0]
    hi = float(max(pa.max(initial=0.0), pb.max(initial=0.0))) / 2.0  # all to the diagonal
    if hi == 0.0 or _bn_feasible(a, b, pa, pb, 0.0):
        return max(0.0, inf_cost)

    # a sound lower bound: every point pays at least min(its diagonal
    # cost, its nearest cross-diagram neighbour); for near twins it is
    # the answer
    if len(a) and len(b):
        ta, tb = cKDTree(a), cKDTree(b)
        lb = max(float(np.max(np.minimum(tb.query(a, k=1, p=np.inf)[0], pa / 2.0),
                              initial=0.0)),
                 float(np.max(np.minimum(ta.query(b, k=1, p=np.inf)[0], pb / 2.0),
                              initial=0.0)))
    else:  # one side empty: everything goes to the diagonal
        lb = hi
    if lb > 0.0 and _bn_feasible(a, b, pa, pb, lb):
        return max(lb, inf_cost)
    lo = lb

    def window_bound() -> int:
        """Cheap overcount of the realized costs in (lo, hi]: pers/2
        values in the window plus the birth-window pair count."""
        c = int(((pa > 2.0 * lo) & (pa <= 2.0 * hi)).sum())
        c += int(((pb > 2.0 * lo) & (pb <= 2.0 * hi)).sum())
        births = np.sort(b[:, 0])
        c += int((np.searchsorted(births, a[:, 0] + hi, side="right")
                  - np.searchsorted(births, a[:, 0] - hi, side="left")).sum())
        return c

    # numeric bisection until the window's realized costs are few enough
    # for the discrete finish (log2(C) checks instead of ~40 halvings)
    while hi - lo > max(rel_tol * hi, 1e-300):
        if window_bound() <= 200_000:
            break
        mid = 0.5 * (lo + hi)
        if mid == lo or mid == hi:
            break
        if _bn_feasible(a, b, pa, pb, mid):
            hi = mid
        else:
            lo = mid

    # exact finish: bisect over the realized costs inside (lo, hi]
    parts = [pa[(pa > 2.0 * lo) & (pa <= 2.0 * hi)] / 2.0,
             pb[(pb > 2.0 * lo) & (pb <= 2.0 * hi)] / 2.0]
    if len(a) and len(b):
        parts.append(_pair_costs_in_window(a, b, lo, hi))
    cand = np.unique(np.concatenate(parts))
    lo_i, hi_i = 0, len(cand) - 1
    while lo_i < hi_i:
        mid_i = (lo_i + hi_i) // 2
        if _bn_feasible(a, b, pa, pb, float(cand[mid_i])):
            hi_i = mid_i
        else:
            lo_i = mid_i + 1
    return max(float(cand[lo_i]), inf_cost)


def wasserstein_distance(dgm_a: np.ndarray, dgm_b: np.ndarray,
                         order: float = 1.0) -> float:
    """Exact q-Wasserstein distance between diagrams (L-inf ground metric,
    diagonal matching allowed) by optimal assignment on the augmented
    bipartite cost matrix (scipy's Hungarian solver).  Infinite bars
    pair across the diagrams by sorted birth; unequal counts give inf."""
    from scipy.optimize import linear_sum_assignment

    a = np.asarray(dgm_a, dtype=np.float64).reshape(-1, 2)
    b = np.asarray(dgm_b, dtype=np.float64).reshape(-1, 2)

    a_inf, b_inf = a[np.isinf(a[:, 1])], b[np.isinf(b[:, 1])]
    a, b = a[np.isfinite(a[:, 1])], b[np.isfinite(b[:, 1])]
    if len(a_inf) != len(b_inf):
        return float("inf")
    inf_cost = float(np.sum(np.abs(np.sort(a_inf[:, 0]) - np.sort(b_inf[:, 0])) ** order)) \
        if len(a_inf) else 0.0

    n, m = len(a), len(b)
    if n == 0 and m == 0:
        return inf_cost ** (1.0 / order) if order != 1.0 else inf_cost

    size = n + m
    cost = np.zeros((size, size))
    if n and m:
        cost[:n, :m] = np.max(np.abs(a[:, None, :] - b[None, :, :]), axis=-1) ** order
    big = cost.max() * 10 + 1.0 if n and m else 1.0
    cost[:n, m:] = big
    cost[n:, :m] = big
    for i in range(n):
        cost[i, m + i] = ((a[i, 1] - a[i, 0]) / 2.0) ** order
    for j in range(m):
        cost[n + j, j] = ((b[j, 1] - b[j, 0]) / 2.0) ** order
    rows, cols = linear_sum_assignment(cost)
    total = float(cost[rows, cols].sum()) + inf_cost
    return total ** (1.0 / order) if order != 1.0 else total
