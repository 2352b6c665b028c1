"""Row-sharded distances, kNN and thresholded edge extraction over a mesh
axis (port of ``tdax/parallel/sharded_ops.py``).

tdax's ``shard_map`` hands each device a contiguous block of the cloud's
rows and the whole cloud beside it, and leaves the result sharded over
the axis.  Here each rank takes its block by ``mesh.local_rank(axis)``
and computes it against the whole cloud; ranks on the mesh's other axes
(tp) compute the same block, as ``shard_map`` replicates over them.  A
block is one true-f32 matrix product in the expansion form
(``scale._expansion_sq_rows``), the counterpart of tdax's ``jnp.dot`` at
``Precision.HIGHEST``, which lies outside any Pallas kernel.

``sharded_pairwise_sq_euclidean`` returns this rank's block (the idiom
of local tensors: ``mesh.all_gather`` reassembles it); ``sharded_knn``
and ``sharded_edge_extract`` gather their per-row results in rank order
and return them on the host, on every rank, as tdax returns them.

Every function here is collective: every rank of the process group calls
it with the same arguments.  A rank that skips the call leaves the
others waiting in the gather until the group's timeout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tdax_torch.parallel import mesh as pm
from tdax_torch.pipeline.scale import _expansion_rows, _expansion_sq_rows, _top_k_kept
from tdax_torch.runtime import as_device_f32


def _row_block(n: int, mesh, axis: str) -> tuple[int, int]:
    """This rank's contiguous rows r0 .. r1 of n over ``axis``; the axis
    size must divide n (tdax's ``shard_map`` refuses otherwise)."""
    p = mesh.shape[axis]
    if n % p:
        raise ValueError(f"{n} rows do not divide over the {p} ranks of mesh axis {axis!r}")
    r0 = mesh.local_rank(axis) * (n // p)
    return r0, r0 + n // p


def sharded_pairwise_sq_euclidean(x, mesh, axis: str = "dp") -> torch.Tensor:
    """x [n, d] -> this rank's [n/p, n] block of max(|x_r|^2 + |x_c|^2 -
    2 x_r.x_c, 0), rows ``local_rank(axis) * n/p`` on, f32 on x's device
    (a tensor stays where it lies; anything else goes to the card).
    Collective; ValueError when the axis size p does not divide n."""
    xj = as_device_f32(x)
    r0, r1 = _row_block(xj.shape[0], mesh, axis)
    sq = (xj * xj).sum(1)
    return _expansion_sq_rows(xj[r0:r1], xj, sq[r0:r1], sq)


def sharded_knn(x, k: int, mesh, axis: str = "dp",
                metric: str = "euclidean") -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN of every point, row-sharded: each rank takes the k
    smallest of its block's rows, and the rows are gathered over
    ``axis`` in rank order.  Returns host (indices [n, k] int32,
    distances [n, k] f32, ascending) on every rank.  Euclidean is the
    root of the clamped expansion form; cosine is clip(1 - x^_r.x^_c, 0,
    2) with the norms clamped at 1e-30 (any other ``metric`` is
    Euclidean, as in tdax).  The self distance is not masked.
    Collective; ValueError when the axis size does not divide n."""
    xj = as_device_f32(x)
    r0, r1 = _row_block(xj.shape[0], mesh, axis)
    if metric == "cosine":
        xn = xj / torch.linalg.vector_norm(xj, dim=1, keepdim=True).clamp_min(1e-30)
        d = (1.0 - xn[r0:r1] @ xn.T).clamp_(0.0, 2.0)
    else:
        sq = (xj * xj).sum(1)
        d = _expansion_rows(xj[r0:r1], xj, sq[r0:r1], sq)
    dists, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    idx = pm.all_gather(idx.to(torch.int32), mesh, axis)
    dists = pm.all_gather(dists, mesh, axis)
    return idx.cpu().numpy(), dists.cpu().numpy()


def sharded_edge_extract(x, thresh: float, row_budget: int, mesh, axis: str = "dp",
                         chunk: int = 2048) -> tuple[np.ndarray, np.ndarray, int]:
    """The sparse scale path's thresholded edges, row-sharded over
    ``axis``: each rank computes expansion-form distances of its rows
    against the whole cloud, ``c`` rows at a time (a [c, n] block live),
    the self distance at +inf, and keeps each row's ``row_budget``
    smallest values within ``thresh``: the kept columns sorted by id
    with n past the kept prefix, and the counts, the contract of the
    one-device blocked extraction (``scale._top_k_kept``).

    Rows are padded with copies of row 0 to a multiple of p * c, c =
    min(chunk, max(1, n // p)), so that every rank's share has one shape
    for the gather; padded rows are dropped after it and do not count as
    truncated.  Returns host (cols [n, row_budget] int32, counts [n]
    int32, n_truncated), n_truncated being the real rows whose
    row_budget-th smallest value is still within the threshold, on every
    rank.  Collective."""
    xj = as_device_f32(x)
    n = xj.shape[0]
    p = mesh.shape[axis]
    c = min(chunk, max(1, n // p))
    m = math.ceil(n / (p * c)) * c           # rows a rank, padding included
    row0 = mesh.local_rank(axis) * m
    sq = (xj * xj).sum(1)
    ar = torch.arange(c, device=xj.device)
    parts = []
    for c0 in range(row0, row0 + m, c):
        rows = c0 + ar
        real = rows < n
        src = torch.where(real, rows, 0)     # a padded row is a copy of row 0
        d = _expansion_rows(xj[src], xj, sq[src], sq)
        d[ar[real], rows[real]] = float("inf")  # drop self
        cols, counts, _, last = _top_k_kept(d, row_budget, thresh)
        truncated = (last <= thresh) & real
        parts.append(torch.cat([cols, counts[:, None], truncated[:, None].long()], 1))
    # one gather: each row's columns, its count and its truncation flag
    rows = pm.all_gather(torch.cat(parts), mesh, axis)[:n].cpu()
    return (rows[:, :row_budget].to(torch.int32).numpy(),
            rows[:, row_budget].to(torch.int32).numpy(), int(rows[:, row_budget + 1].sum()))
