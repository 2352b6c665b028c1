"""Sparse (CSR) Rips: a thresholded neighbour graph into the native
sparse cohomology engine (port of ``tdax/ops/rips/sparse.py``).

The scale path's transfer-light mode: instead of the full [n, n]
distance matrix, only the kept edges (~n * degree entries) reach the
host, as the symmetric CSR that ``cpp/tdax_rips_sparse.cc`` consumes
through the port's own binding (``native._library``).

Completeness: the thresholded Rips filtration lies wholly in the k-NN
graph iff no vertex has k or more neighbours within the threshold.
``csr_from_knn`` checks this (every row that kept all its k - 1
non-self entries must have its k-th distance above the threshold) and
raises otherwise; it never truncates.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tdax_torch.ops.rips import native


def csr_from_knn(knn_idx: np.ndarray, knn_dist: np.ndarray,
                 thresh: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indices [n, k], dists [n, k]) self-first top-k lists -> symmetric
    CSR (indptr int64, indices int32, data float32) of the thresholded
    graph."""
    n, k = knn_idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = knn_idx.reshape(-1).astype(np.int64)
    vals = knn_dist.reshape(-1).astype(np.float32)

    keep = (vals <= thresh) & (rows != cols)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    # a row that kept all k - 1 non-self entries may be truncated: its
    # k-th distance must exceed the threshold
    kth = knn_dist[:, -1]
    full_rows = np.bincount(rows, minlength=n) >= k - 1
    bad = full_rows & (kth <= thresh)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} rows have >= k neighbors within the threshold; "
            f"increase k (got {k}) or lower the threshold for a complete "
            f"sparse filtration")

    # symmetrize, then drop duplicates (the first of each key stays)
    a = np.concatenate([rows, cols])
    b = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals])
    key = a * n + b
    order = np.argsort(key, kind="stable")
    key, a, b, v = key[order], a[order], b[order], v[order]
    uniq = np.ones(len(key), dtype=bool)
    uniq[1:] = key[1:] != key[:-1]
    a, b, v = a[uniq], b[uniq], v[uniq]

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, a + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, b.astype(np.int32), v.astype(np.float32)


def rips_sparse(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                maxdim: int = 1) -> list[np.ndarray]:
    """VR diagrams of a symmetric CSR graph (rows sorted by column, no
    self entries) in the native sparse engine; one [k, 2] array per
    dimension, sorted by (birth, death), inf deaths for essential bars."""
    lib = native._library()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    out_ptr = ctypes.POINTER(ctypes.c_double)()
    out_len = ctypes.c_long(0)
    rc = lib.tdax_rips_sparse(n, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                              data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              maxdim, ctypes.byref(out_ptr), ctypes.byref(out_len))
    if rc == 3:
        raise ValueError("sparse engine supports maxdim <= 3")
    if rc == 4:
        raise MemoryError("sparse engine ran out of memory during reduction")
    if rc != 0:
        raise RuntimeError(f"tdax_rips_sparse failed with code {rc}")
    return native.bars_from_records(lib, out_ptr, out_len, maxdim)
