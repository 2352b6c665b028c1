"""Batched Vietoris-Rips H0/H1/H2 of tiny clouds on the device (port of
``tdax/ops/rips/tiny_device.py``).

A whole batch of small clouds (the sweep's 32 layers of 36 points) is
reduced at once, with tensors over the cloud axis, on the card or, when
the caller asks, on the CPU.  At n = 36 the complex has 630 edges, 7140
triangles and 58,905 tetrahedra: the dim-2 and dim-3 boundary matrices
fit on the device bit-packed (the tetrahedron matrix is ~105 MB a
cloud, so H2 chunks the batch).

The algorithm is tdax's (standard-algorithm pairing):
  * the total order of simplices is ascending (diameter, colex index),
    the order of the oracle and the native engine, so the pairing is
    theirs (the persistence pairing of a filtration is unique);
  * H0 from a Boruvka MST per cloud (``mst.boruvka_batched``);
  * H1 reduces the triangle-by-edge boundary matrix over Z/2, H2 the
    tetrahedron-by-triangle one.  Columns are bit-packed (16 rows to an
    int32 word) and reduced by parallel Jacobi sweeps: each sweep finds
    every column's low, elects the earliest column of each pivot row
    and XORs it into the later columns that share that low.  An XOR
    lowers a column's low, so the sweeps reach a fixpoint, where all
    lows are distinct: the matrix is reduced and its lows are the
    persistence pairs;
  * thresh = inf is the enclosing radius, where the complex cones off.

Eager PyTorch changes the form, not the values: tdax's holder election
(a stable sort by low and a segmented scan) is a min of column indices
scattered onto their lows; its ``while_loop`` is a Python loop that
reads the count of conflicting columns after each sweep (one host sync
a sweep on the card) and touches only those columns; its ``.at[].add``
is an int32 ``scatter_add_`` (a column's faces set distinct bits, so the
sum is exact in any order).  The sweep counts are tdax's.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from tdax_torch.ops.rips.mst import boruvka_batched
from tdax_torch.runtime import as_device_f32

_BITS = 16          # rows per packed word (int32 words, values < 2^16)
_MAX_SWEEPS = 4096  # bound on the sweeps; not converged there raises

# the last call's sweep counts and stage times (host clock; every stage
# ends in a copy of its result to the host)
LAST_RUN: dict = {}


@functools.lru_cache(maxsize=8)
def _combinatorics(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Edges [E, 2] in colex order (index of (i<j) is C(j,2)+i) and
    triangle -> edge ids [T, 3], triangles in colex order."""
    eij = np.array([(i, j) for j in range(n) for i in range(j)], np.int32).reshape(-1, 2)

    def eid(i, j):
        return j * (j - 1) // 2 + i

    tri = np.array([[eid(i, j), eid(i, k), eid(j, k)]
                    for k in range(n) for j in range(k) for i in range(j)],
                   np.int32).reshape(-1, 3)
    return eij, tri


@functools.lru_cache(maxsize=8)
def _combinatorics3(n: int) -> np.ndarray:
    """Tetrahedron -> triangle ids [Q, 4], tetrahedra in colex order
    (index of (i<j<k<l) is C(l,4)+C(k,3)+C(j,2)+i)."""
    def tid(i, j, k):
        return k * (k - 1) * (k - 2) // 6 + j * (j - 1) // 2 + i

    return np.array([[tid(j, k, l), tid(i, k, l), tid(i, j, l), tid(i, j, k)]
                     for l in range(n) for k in range(l)
                     for j in range(k) for i in range(j)], np.int32).reshape(-1, 4)


def _low_of(m: torch.Tensor) -> torch.Tensor:
    """[..., W] packed columns -> [...] index of each column's lowest
    (last) set row, -1 for an empty column."""
    w_iota = torch.arange(m.shape[-1], dtype=torch.int32, device=m.device)
    wmax = torch.where(m > 0, w_iota, -1).amax(-1)
    vw = m.gather(-1, wmax.clamp_min(0).long()[..., None])
    pow2 = 2 ** torch.arange(1, _BITS, device=m.device, dtype=torch.int32)
    hsb = (vw >= pow2).sum(-1)
    return torch.where(wmax >= 0, wmax.long() * _BITS + hsb, -1)


def _jacobi_reduce(mat: torch.Tensor) -> tuple[torch.Tensor, bool, int, torch.Tensor]:
    """Reduce a bit-packed [L, C, W] Z/2 boundary matrix (columns = higher
    simplices in filtration order, bit r = row r in filtration order) in
    place, to distinct lows.  Returns (mat, converged, sweeps, lows).

    Each sweep elects the earliest column of every low (a min of column
    indices over their lows: tdax's stable sort and segmented scan find
    the same column) and XORs it into the later ones.  Only those columns
    change, so only they are read, written and given new lows; the
    sweeps are tdax's, one for one."""
    l_cnt, c_cnt, w_cnt = mat.shape
    dev = mat.device
    flat = mat.view(l_cnt * c_cnt, w_cnt)
    col = torch.arange(c_cnt, device=dev).expand(l_cnt, c_cnt)
    base = (torch.arange(l_cnt, device=dev) * c_cnt)[:, None]
    none = w_cnt * _BITS  # a slot past every row, for columns without a low
    low = _low_of(mat)
    for sweeps in range(1, _MAX_SWEEPS + 1):
        slot = torch.where(low >= 0, low, none)
        holder = torch.full((l_cnt, none + 1), c_cnt, device=dev).scatter_reduce_(
            1, slot, col, "amin").gather(1, slot)
        dst = ((low >= 0) & (holder < col)).view(-1).nonzero().squeeze(1)
        if dst.numel() == 0:
            return mat, True, sweeps, low
        src = (base + holder).view(-1)[dst]
        flat[dst] = flat[dst] ^ flat[src]  # holders are not in conflict: unchanged here
        low.view(-1)[dst] = _low_of(flat[dst])
    return mat, False, _MAX_SWEEPS, low


def _pack_and_reduce(face_rank, cof_faces, cof_order, cof_valid_sorted, cof_diam_sorted,
                     r_cnt: int):
    """Build the bit-packed boundary matrix of the cofacets (columns, put
    in filtration order by ``cof_order``) over the faces (rows, ranks from
    ``face_rank``), reduce it, and scatter each pivot's death onto its
    face row.  Returns (deaths [L, R], converged, sweeps)."""
    l_cnt = face_rank.shape[0]
    c_cnt, f_cnt = cof_faces.shape
    w_cnt = -(-r_cnt // _BITS)
    dev = face_rank.device

    rows = face_rank[:, cof_faces].gather(1, cof_order[:, :, None].expand(-1, -1, f_cnt))
    word, bit = rows // _BITS, rows % _BITS
    cell = ((torch.arange(l_cnt, device=dev)[:, None, None] * c_cnt
             + torch.arange(c_cnt, device=dev)[None, :, None]) * w_cnt + word)
    vals = (1 << bit) * cof_valid_sorted[:, :, None]
    mat = torch.zeros(l_cnt * c_cnt * w_cnt, dtype=torch.int32, device=dev)
    mat.scatter_add_(0, cell.view(-1), vals.view(-1).to(torch.int32))

    _, converged, sweeps, low = _jacobi_reduce(mat.view(l_cnt, c_cnt, w_cnt))
    has = low >= 0
    # at convergence the lows are distinct: one death per face row
    deaths = torch.full((l_cnt, r_cnt), -float("inf"), device=dev).scatter_reduce_(
        1, torch.where(has, low, 0), torch.where(has, cof_diam_sorted, -float("inf")), "amax")
    return deaths, converged, sweeps


def _filtration_sort(diam: torch.Tensor, valid: torch.Tensor):
    """Ascending (diameter, colex) order over colex-ordered simplices.
    Returns (order, inverse rank, sorted diameters, sorted validity)."""
    order = torch.argsort(torch.where(valid, diam, float("inf")), dim=-1, stable=True)
    iota = torch.arange(diam.shape[-1], device=diam.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, iota)
    return order, rank, diam.gather(1, order), valid.gather(1, order)


def _edge_diameters(x: torch.Tensor, n: int):
    """f32 difference-form distances [L, n, n], the enclosing radius [L]
    and the colex edge and triangle diameters [L, E], [L, T]."""
    eij, tri_e = (torch.as_tensor(a, dtype=torch.long, device=x.device)
                  for a in _combinatorics(n))
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = (diff * diff).sum(-1).clamp_min(0.0).sqrt()
    radius = dist.amax(-1).amin(-1)
    ed = dist[:, eij[:, 0], eij[:, 1]]
    td = ed[:, tri_e].amax(-1)
    return dist, radius, ed, td, tri_e


def _tiny_h1_pairs(clouds: torch.Tensor, n: int):
    """clouds [L, n, d] f32 -> (births [L, E] sorted edge diameters,
    deaths [L, E] death per edge row or -inf, mst [L, n-1], converged,
    sweeps)."""
    dist, radius, ed, td, tri_e = _edge_diameters(clouds, n)
    mst = boruvka_batched(dist)
    _, e_rank, ed_sorted, _ = _filtration_sort(ed, ed <= radius[:, None])
    t_order, _, td_sorted, tv_sorted = _filtration_sort(td, td <= radius[:, None])
    deaths, converged, sweeps = _pack_and_reduce(e_rank, tri_e, t_order, tv_sorted,
                                                 td_sorted, ed.shape[1])
    return ed_sorted, deaths, mst, converged, sweeps


def _tiny_h2_pairs(clouds: torch.Tensor, n: int):
    """clouds [L, n, d] f32 -> (births [L, T] sorted triangle diameters,
    deaths [L, T] death per triangle row or -inf, converged, sweeps).
    Every pivot row of the tetrahedron-by-triangle reduction is a positive
    triangle (the standard algorithm's pairs are disjoint), so its lows
    are the H2 pairs."""
    _, radius, _, td, _ = _edge_diameters(clouds, n)
    tet_t = torch.as_tensor(_combinatorics3(n), dtype=torch.long, device=clouds.device)
    qd = td[:, tet_t].amax(-1)
    _, t_rank, td_sorted, _ = _filtration_sort(td, td <= radius[:, None])
    q_order, _, qd_sorted, qv_sorted = _filtration_sort(qd, qd <= radius[:, None])
    deaths, converged, sweeps = _pack_and_reduce(t_rank, tet_t, q_order, qv_sorted, qd_sorted,
                                                 td.shape[1])
    return td_sorted, deaths, converged, sweeps


def _pairs_to_dgm(births: np.ndarray, deaths: np.ndarray) -> np.ndarray:
    """Positive-persistence (birth, death) rows, diagram-sorted."""
    keep = deaths > births
    dgm = np.stack([births[keep], deaths[keep]], axis=1).reshape(-1, 2)
    if len(dgm):
        dgm = dgm[np.lexsort((dgm[:, 1], dgm[:, 0]))]
    return dgm


def _h2_chunk_size(l_cnt: int, n: int) -> int:
    """Clouds per H2 reduction.  The tetrahedron-by-triangle matrix is
    C(n,4) x ceil(C(n,3)/16) int32 words (~105 MB at n = 36) and a sweep
    holds ~4 copies of it; the chunk keeps that near 3.5 GB unless
    TDAX_TINY_H2_CHUNK says otherwise (tdax's rule)."""
    env = os.environ.get("TDAX_TINY_H2_CHUNK")
    if env:
        return max(1, min(l_cnt, int(env)))
    q_cnt = n * (n - 1) * (n - 2) * (n - 3) // 24
    w_cnt = -(-(n * (n - 1) * (n - 2) // 6) // _BITS)
    per_cloud = q_cnt * w_cnt * 4 * 4
    return max(1, min(l_cnt, int(3.5e9 // max(per_cloud, 1))))


def rips_tiny_batched(clouds, maxdim: int = 1, device=None) -> list[list[np.ndarray]]:
    """VR diagrams [dgm0, ..., dgm_maxdim] of each cloud of an [L, n, d]
    batch, maxdim <= 2, reduced on the device for the whole batch at once
    (H2 a chunk of clouds at a time, the tail chunk padded with cloud 0).
    ``clouds`` is placed by ``runtime.as_device_f32``: a tensor stays
    where it lies, an array goes to the card unless ``device`` says
    otherwise.  Raises RuntimeError when a reduction does not converge
    within ``_MAX_SWEEPS`` sweeps."""
    if maxdim not in (0, 1, 2):
        raise ValueError("rips_tiny_batched supports maxdim <= 2")
    x = as_device_f32(clouds, device)
    l_cnt, n = x.shape[0], x.shape[1]
    if n < 3:  # tdax's reduction fails there too; the native engine takes any n
        raise ValueError(f"rips_tiny_batched needs at least 3 points a cloud (got {n})")
    # memory bounds, not correctness: the H1 triangle matrix at n = 100 is
    # ~200 MB a cloud; past that the native engine is the backend to use
    if n > 100:
        raise ValueError(f"rips_tiny_batched is limited to n <= 100 points (got {n}): "
                         "use the native engine for larger clouds")
    if maxdim == 2 and n > 48:
        raise ValueError(f"rips_tiny_batched maxdim=2 is limited to n <= 48 (got {n}): "
                         "the tet-by-triangle matrix is ~840 MB/cloud at n=48; use the "
                         "native engine")

    run = {"clouds": l_cnt, "n": n, "maxdim": maxdim}
    t = time.perf_counter()
    births, deaths, mst, converged, sweeps = _tiny_h1_pairs(x, n)
    if not converged:
        raise RuntimeError(f"tiny-device rips reduction did not converge within "
                           f"{_MAX_SWEEPS} sweeps")
    births, deaths, mst = (a.cpu().numpy().astype(np.float64) for a in (births, deaths, mst))
    run.update(h1_sweeps=sweeps, h1_s=time.perf_counter() - t)

    if maxdim == 2:
        chunk = _h2_chunk_size(l_cnt, n)
        b2_parts, d2_parts = [], []
        run.update(h2_chunk=chunk, h2_sweeps=[], h2_chunk_s=[])
        for s in range(0, l_cnt, chunk):
            t = time.perf_counter()
            part = x[s:s + chunk]
            pad = chunk - part.shape[0]
            if pad:  # as tdax: every chunk has one shape
                part = torch.cat([part, x[:1].expand(pad, *x.shape[1:])])
            b2, d2, conv2, sweeps2 = _tiny_h2_pairs(part, n)
            if not conv2:
                raise RuntimeError(f"tiny-device H2 reduction did not converge within "
                                   f"{_MAX_SWEEPS} sweeps")
            take = min(chunk, l_cnt - s)
            b2_parts.append(b2.cpu().numpy().astype(np.float64)[:take])
            d2_parts.append(d2.cpu().numpy().astype(np.float64)[:take])
            run["h2_sweeps"].append(sweeps2)
            run["h2_chunk_s"].append(time.perf_counter() - t)
            del b2, d2
        births2, deaths2 = np.concatenate(b2_parts), np.concatenate(d2_parts)
    LAST_RUN.clear()
    LAST_RUN.update(run)

    out: list[list[np.ndarray]] = []
    for i in range(l_cnt):
        w = mst[i]
        finite = w[np.isfinite(w)]
        finite = finite[finite > 0]
        n_comp = 1 + int(np.sum(~np.isfinite(w)))
        dgm0 = np.asarray([[0.0, float(v)] for v in np.sort(finite)]
                          + [[0.0, np.inf]] * n_comp).reshape(-1, 2)
        dgms = [dgm0]
        if maxdim >= 1:
            dgms.append(_pairs_to_dgm(births[i], deaths[i]))
        if maxdim >= 2:
            dgms.append(_pairs_to_dgm(births2[i], deaths2[i]))
        out.append(dgms)
    return out
