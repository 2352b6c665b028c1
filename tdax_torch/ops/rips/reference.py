"""Pure-numpy Vietoris-Rips persistent cohomology — the correctness oracle
(the port's own copy of ``tdax/ops/rips/reference.py``; same output).

Algorithm (standard persistent-cohomology formulation, the same family
as the reference's ripser dependency, re-derived and implemented from
scratch):

  * dim 0 by union-find over edges sorted ascending by (diameter, index);
    a merging edge closes an H0 bar (0, d); non-merging edges become the
    columns-to-reduce for dim 1 (clearing).
  * dim p >= 1 by coboundary-matrix reduction: p-simplex columns
    processed in decreasing (diameter, index) order; the pivot of a
    column is its minimal-(diameter, index) (p+1)-cofacet; columns with
    claimed pivots accumulate the owner's V-column (re-enumerated
    coboundaries) until the pivot is free or the column vanishes.
    A claimed pivot yields the homology pair (diam sigma, diam tau);
    a vanished column is an essential class (birth, inf).
  * pivots of dim p become the cleared set for dim p+1.
  * thresh=inf uses the enclosing radius min_i max_j d(i,j) — the
    complex cones off at that radius, so diagrams are exact.

Z/2 coefficients.  Zero-persistence pairs (death <= birth) are dropped
from the output, matching ripser's default ratio=1 behavior (the
committed golden diagrams contain no diagonal points).
"""

from __future__ import annotations

import heapq
from typing import Iterable

import numpy as np


def enclosing_radius(dist: np.ndarray) -> float:
    """min_i max_j d(i, j): the cone radius; bars never die later."""
    return float(np.min(np.max(dist, axis=1)))


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def _edge_list(dist: np.ndarray, thresh: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangle edges with d <= thresh, as (i, j, d) arrays."""
    n = dist.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    d = dist[iu, ju]
    keep = d <= thresh
    return iu[keep], ju[keep], d[keep]


def _dim0(dist: np.ndarray, thresh: float) -> tuple[np.ndarray, list[tuple[float, int, int]]]:
    """H0 diagram + non-merging (positive) edges for the dim-1 columns.

    Returns (dgm0 [k,2] with inf deaths for essential classes,
    positive_edges as (diameter, i, j) in ascending filtration order).
    """
    n = dist.shape[0]
    ei, ej, ed = _edge_list(dist, thresh)
    # ascending (diameter, colex index); colex index of (i<j) is C(j,2)+i,
    # monotonic in (j, i) — sort by (d, j, i).
    order = np.lexsort((ei, ej, ed))
    uf = _UnionFind(n)
    deaths: list[float] = []
    positive: list[tuple[float, int, int]] = []
    for k in order:
        i, j, d = int(ei[k]), int(ej[k]), float(ed[k])
        if uf.union(i, j):
            if d > 0:
                deaths.append(d)
        else:
            positive.append((d, i, j))
    n_components = len({uf.find(v) for v in range(n)})
    bars = [(0.0, d) for d in deaths] + [(0.0, np.inf)] * n_components
    dgm0 = np.array(bars, dtype=np.float64).reshape(-1, 2)
    return dgm0, positive


def _simplex_diameter(dist: np.ndarray, verts: tuple[int, ...]) -> float:
    d = 0.0
    for a in range(len(verts)):
        for b in range(a + 1, len(verts)):
            dd = dist[verts[a], verts[b]]
            if dd > d:
                d = dd
    return float(d)


def _enumerate_simplices(dist: np.ndarray, thresh: float, p: int) -> list[tuple[float, tuple[int, ...]]]:
    """All p-simplices with diameter <= thresh as (diam, sorted-vertex-tuple).

    Grown from (p-1)-simplices by appending a strictly larger vertex
    adjacent (within thresh) to every member.
    """
    n = dist.shape[0]
    if p == 0:
        return [(0.0, (v,)) for v in range(n)]
    prev = _enumerate_simplices(dist, thresh, p - 1)
    out: list[tuple[float, tuple[int, ...]]] = []
    for diam, verts in prev:
        top = verts[-1]
        for w in range(top + 1, n):
            dmax = diam
            ok = True
            for v in verts:
                dv = dist[v, w]
                if dv > thresh:
                    ok = False
                    break
                if dv > dmax:
                    dmax = dv
            if ok:
                out.append((dmax, verts + (w,)))
    return out


def _cofacets(dist: np.ndarray, thresh: float, verts: tuple[int, ...], diam: float,
              n: int) -> Iterable[tuple[float, tuple[int, ...]]]:
    """Cofacets of a simplex in increasing colex (combinatorial-index) order.

    Colex order over vertex sets is monotone in the added vertex w, so
    enumerating w ascending yields cofacets in ascending index order —
    the property the emergent-pair shortcut in the native engine relies
    on; kept identical here for apples-to-apples testing.
    """
    vset = set(verts)
    for w in range(n):
        if w in vset:
            continue
        dmax = diam
        ok = True
        for v in verts:
            dv = dist[v, w]
            if dv > thresh:
                ok = False
                break
            if dv > dmax:
                dmax = dv
        if ok:
            yield dmax, tuple(sorted(verts + (w,)))


def _reduce_dimension(dist: np.ndarray, thresh: float,
                      columns: list[tuple[float, tuple[int, ...]]],
                      essential_allowed: bool) -> tuple[np.ndarray, set[tuple[int, ...]]]:
    """Coboundary reduction for one dimension.

    ``columns``: (diam, verts) of the p-simplices to reduce (already
    cleared).  Returns (dgm_p, pivot (p+1)-simplices for clearing).
    """
    n = dist.shape[0]
    # Filtration order key for cofacet rows: (diam, colex) — colex over
    # sorted-vertex tuples compares reversed tuples lexicographically.
    def row_key(diam: float, verts: tuple[int, ...]):
        return (diam, verts[::-1])

    # Process columns in decreasing (diam, colex) order.
    columns_sorted = sorted(columns, key=lambda c: (c[0], c[1][::-1]), reverse=True)

    pivot_owner: dict[tuple[int, ...], list[tuple[float, tuple[int, ...]]]] = {}
    bars: list[tuple[float, float]] = []
    pivots: set[tuple[int, ...]] = set()

    for diam, verts in columns_sorted:
        # Working coboundary as a min-heap of row keys; Z/2 cancellation by
        # popping equal pairs.
        heap: list[tuple[tuple, float, tuple[int, ...]]] = []
        v_column: list[tuple[float, tuple[int, ...]]] = [(diam, verts)]

        def push_coboundary(sdiam: float, sverts: tuple[int, ...]) -> None:
            for cdiam, cverts in _cofacets(dist, thresh, sverts, sdiam, n):
                heapq.heappush(heap, (row_key(cdiam, cverts), cdiam, cverts))

        push_coboundary(diam, verts)

        while True:
            # pop Z/2-cancelling duplicates to expose the true pivot
            pivot = None
            while heap:
                top = heapq.heappop(heap)
                if heap and heap[0][0] == top[0]:
                    heapq.heappop(heap)  # cancels mod 2
                    continue
                pivot = top
                break
            if pivot is None:
                # zero column -> essential class
                if not essential_allowed:
                    raise AssertionError(
                        "zero column under enclosing-radius threshold — "
                        "filtration should be acyclic above dim 0")
                bars.append((diam, np.inf))
                break
            _, pdiam, pverts = pivot
            owner = pivot_owner.get(pverts)
            if owner is None:
                pivot_owner[pverts] = v_column
                pivots.add(pverts)
                if pdiam > diam:
                    bars.append((diam, pdiam))
                break
            # add the owner's column (V-column re-expansion), keep pivot popped
            # out: we must push the pivot back first since owner includes it too
            heapq.heappush(heap, pivot)
            for sdiam, sverts in owner:
                v_column.append((sdiam, sverts))
                push_coboundary(sdiam, sverts)

    dgm = np.array(bars, dtype=np.float64).reshape(-1, 2)
    return dgm, pivots


def rips_reference(dist: np.ndarray, maxdim: int = 1,
                   thresh: float = np.inf) -> list[np.ndarray]:
    """VR persistence diagrams [dgm0, ..., dgm_maxdim] from a dense
    distance matrix.  Oracle implementation — O(small) only."""
    dist = np.asarray(dist, dtype=np.float64)
    n = dist.shape[0]
    if n == 0:
        return [np.zeros((0, 2))] * (maxdim + 1)

    user_inf = np.isinf(thresh)
    thresh_eff = enclosing_radius(dist) if user_inf else float(thresh)
    essential_allowed = not user_inf

    dgm0, positive_edges = _dim0(dist, thresh_eff)
    dgms = [dgm0]

    columns = [(d, (i, j)) for d, i, j in positive_edges]
    for p in range(1, maxdim + 1):
        dgm_p, pivots = _reduce_dimension(dist, thresh_eff, columns, essential_allowed)
        dgms.append(dgm_p)
        if p < maxdim:
            all_next = _enumerate_simplices(dist, thresh_eff, p + 1)
            columns = [(d, v) for d, v in all_next if v not in pivots]
    # deterministic output order: by (birth, death)
    out = []
    for dgm in dgms:
        if len(dgm):
            idx = np.lexsort((dgm[:, 1], dgm[:, 0]))
            dgm = dgm[idx]
        out.append(dgm)
    return out
