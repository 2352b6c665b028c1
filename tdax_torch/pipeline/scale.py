"""Large-cloud Vietoris-Rips (port of ``tdax/pipeline/scale.py``).

BASELINE.json configs[4]: 10k points, raw 4096-d, H0..H2 under a
threshold.  Two paths.

The dense path, ``rips_at_scale``:
  * the O(n^2 d) distance matrix on the card, through the hand-written
    kernel (``tdax_torch.ops.sqdist``, replacing tdax's Pallas
    ``_sqdist_kernel``), in the expansion form;
  * H0 on the card (Boruvka MST, ``tdax_torch.ops.rips.mst``) on the
    copy of the matrix already there (``h0_on_device=False`` keeps the
    engine's dim-0 bars instead);
  * H1/H2 in the native C++ cohomology engine on the host, with an
    explicit threshold (at 10k points the full complex has ~1.7e11
    triangles).

The sparse path, ``rips_at_scale_sparse`` (``bench_scale.py``'s
default): the card picks a degree-targeted threshold and extracts only
the edges within it (~n * degree of them, never the [n, n] matrix on
the host), refines their values in difference form, and the CSR
engine (``tdax_torch.ops.rips.sparse``) computes H0..maxdim on the
host.  Up to ``fused_max`` points the whole matrix comes from
``distance_matrix`` (``sqdist_sm90.cu`` on the card) in one pass;
above it, row blocks of true-f32 matrix products bound device memory at
``block_rows * n``.

Precision: edge MEMBERSHIP is decided in the expansion form
(|x|^2 + |y|^2 - 2xy), the kept edges' VALUES in difference form
(``_refine_edge_values``), which removes the expansion form's
cancellation: at |x|^2 ~ 1e3 f32 quantizes d^2 into ~1e-4 buckets and
ties millions of edges onto a few thousand diameters.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tdax_torch.ops.rips import rips_from_distances, rips_sparse
from tdax_torch.ops.rips.mst import h0_diagram_device
from tdax_torch.ops.sqdist import euclidean
from tdax_torch.parallel import mesh as pm
from tdax_torch.runtime import as_device_f32, get_device

THRESH_SAMPLE = 512      # rows whose k-th distance picks the threshold
REFINE_BLOCK = 131072    # edges refined per pass: two [block, d] gathers


def distance_matrix(x, device=None, mesh=None) -> torch.Tensor:
    """[n, d] -> [n, n] f32 Euclidean distances on the device (tdax's
    ``distance_matrix_tpu``, which returns the host copy).  Symmetrized
    exactly, (d + d^T) * 0.5 in f32, for the combinatorial engine.

    With ``mesh`` the call is collective (every rank of the mesh makes
    it, with the same ``x``): each rank computes its row block over dp in
    true f32 (``sharded_pairwise_sq_euclidean``), takes its root, and the
    blocks are gathered in rank order; every rank returns the whole
    matrix.  As on tdax's mesh path the diagonal is not zeroed: the
    expansion form may leave a small positive value there."""
    xj = as_device_f32(x, device)
    if mesh is not None:
        from tdax_torch.parallel.sharded_ops import sharded_pairwise_sq_euclidean
        d = pm.all_gather(sharded_pairwise_sq_euclidean(xj, mesh).sqrt_(), mesh, "dp")
    else:
        d = euclidean(xj)
    d = d + d.T
    return d.mul_(0.5)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rips_at_scale(x, maxdim: int = 2, thresh: float = np.inf, device=None,
                  h0_on_device: bool = True, mesh=None) -> dict:
    """VR persistence of a large cloud: distances on the card, H0 by
    Boruvka on the card (``h0_on_device``, the default; else the engine's
    dim-0 bars), H1+ in the native engine.  Returns {"dgms": [...],
    "timings": {stage: s}} (host clock; each device stage ends in a
    synchronise).

    With ``mesh`` the call is collective: the matrix is
    ``distance_matrix(mesh=)``'s, H0 and the engine run on the mesh's
    first rank alone (ranks sharing a host run one engine), and its
    result, timings included, is broadcast to every rank."""
    timings = {}
    t = time.perf_counter()
    dist = distance_matrix(x, device, mesh)
    _sync(dist.device)
    timings["distance_s"] = time.perf_counter() - t
    if mesh is not None and not pm.is_first_rank(mesh):
        del dist
        return pm.broadcast_object(None, mesh)

    def out(result: dict) -> dict:
        return result if mesh is None else pm.broadcast_object(result, mesh)

    if h0_on_device:
        t = time.perf_counter()
        dgm0 = h0_diagram_device(dist, thresh)
        timings["h0_s"] = time.perf_counter() - t
        if maxdim == 0:
            return out({"dgms": [dgm0], "timings": timings})

    t = time.perf_counter()
    host = dist.cpu().numpy()
    del dist
    timings["to_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    result = rips_from_distances(host, maxdim=maxdim, thresh=thresh)
    timings["engine_s"] = time.perf_counter() - t
    if h0_on_device:
        # the on-device H0 replaces the engine's dim-0 output
        result["dgms"][0] = dgm0
    result["timings"] = timings
    return out(result)


# --- the sparse path -------------------------------------------------------------

def _sample_rows(n: int, sample: int, device) -> torch.Tensor:
    """tdax's evenly spaced sample rows, built on the host as tdax builds them."""
    rows = np.linspace(0, n - 1, min(sample, n)).astype(np.int32)
    return torch.as_tensor(rows, dtype=torch.int64, device=device)


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: for an even count the two middle values' midpoint,
    (lo + hi) * 0.5 in the input's dtype (``torch.median`` returns lo)."""
    s = torch.sort(v).values
    m = s.numel()
    return (s[(m - 1) // 2] + s[m // 2]) * 0.5


def _kth_median(d_rows: torch.Tensor, target_degree: int) -> torch.Tensor:
    """Median over the rows of each row's target_degree-th neighbour
    distance.  A sampled row holds its own ~0 self distance, so the
    (target_degree + 1)-th smallest entry, self included, is it."""
    kth = torch.topk(d_rows, target_degree + 1, dim=1, largest=False, sorted=True).values[:, -1]
    return _median(kth)


def _expansion_sq_rows(x_rows: torch.Tensor, x_full: torch.Tensor, sq_rows: torch.Tensor,
                       sq_full: torch.Tensor) -> torch.Tensor:
    """[m, n] expansion-form squared distances max(|x_r|^2 + |x_c|^2 - 2 x_r.x_c, 0)
    from one true-f32 matrix product; rounding as tdax's (s - 2g, with 2g exact)."""
    g = x_rows @ x_full.T
    g.mul_(-2.0).add_(sq_rows[:, None] + sq_full[None, :])
    return g.clamp_min_(0.0)


def _expansion_rows(x_rows: torch.Tensor, x_full: torch.Tensor, sq_rows: torch.Tensor,
                    sq_full: torch.Tensor) -> torch.Tensor:
    """[m, n] expansion-form distances, the root of ``_expansion_sq_rows``."""
    return _expansion_sq_rows(x_rows, x_full, sq_rows, sq_full).sqrt_()


def _select_threshold(xj: torch.Tensor, n: int, target_degree: int,
                      sample: int = THRESH_SAMPLE) -> float:
    """Degree-targeted threshold: the median over ``sample`` evenly spaced
    rows of each row's target_degree-th smallest distance, computed on
    xj's device; only the scalar comes back."""
    rows = _sample_rows(n, sample, xj.device)
    xs = xj[rows]
    d = _expansion_rows(xs, xj, (xs * xs).sum(1), (xj * xj).sum(1))
    return float(_kth_median(d, target_degree))


def _prefix_counts(keep: torch.Tensor, k: int):
    """Per-row kept-neighbour counts, and whether the keep mask is a
    PREFIX of every row (the top-k values ascend per row and keep is
    vals <= t, so it must be)."""
    counts = keep.sum(1, dtype=torch.int64)
    slots = torch.arange(k, device=keep.device)[None, :]
    prefix_ok = (keep == (slots < counts[:, None])).all()
    return counts, prefix_ok


def _top_k_kept(d: torch.Tensor, k: int, t) -> tuple:
    """Each row's k smallest entries of d (self already +inf): the kept
    columns (vals <= t) sorted by id with n past the prefix, the counts,
    the prefix check and the last value of each row."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    keep = vals <= t
    counts, prefix_ok = _prefix_counts(keep, k)
    cols = torch.sort(torch.where(keep, idx, d.shape[1]), dim=1).values
    return cols, counts, prefix_ok, vals[:, -1]


def _fused_extract_small(xj: torch.Tensor, n: int, target_degree: int, budget: int):
    """For n small enough to hold the [n, n] matrix: the threshold and
    the thresholded edge extraction from one distance matrix, the port's
    ``distance_matrix`` (expansion form, sqrt, (d + d^T) / 2 exactly
    symmetric; ``sqdist_sm90.cu`` on the card)."""
    d = distance_matrix(xj)
    t = _kth_median(d[_sample_rows(n, THRESH_SAMPLE, xj.device)], target_degree)
    d.fill_diagonal_(float("inf"))  # drop self
    cols, counts, prefix_ok, last = _top_k_kept(d, budget, t)
    del d
    # completeness: a row whose k-th smallest is still within the
    # threshold was truncated (k == n - 1 holds every neighbour)
    truncated = (last <= t).sum() if budget < n - 1 else torch.zeros((), dtype=torch.int64)
    return cols, counts, prefix_ok, truncated, t


def _extract_block(xj: torch.Tensor, sq: torch.Tensor, row0: int, row1: int, t: float,
                   k: int):
    """Rows row0..row1 of the thresholded graph from a [rows, n] block of
    true-f32 expansion-form distances."""
    d = _expansion_rows(xj[row0:row1], xj, sq[row0:row1], sq)
    ar = torch.arange(row1 - row0, device=xj.device)
    d[ar, row0 + ar] = float("inf")  # drop self
    cols, counts, prefix_ok, last = _top_k_kept(d, k, t)
    return cols, counts, prefix_ok, (last <= t).sum()


def _edges_from_prefix(idx: torch.Tensor, counts: torch.Tensor, prefix_ok: bool):
    """Per-row prefix counts of idx [n, k] -> (r int64, c int32) directed
    edges, rows ascending and columns ascending within a row, on idx's
    device."""
    if not prefix_ok:
        raise RuntimeError(
            "top-k returned per-row values that are not ascending; the "
            "prefix-count edge extraction assumed sorted rows")
    r = torch.repeat_interleave(torch.arange(len(counts), device=idx.device), counts)
    mask = torch.arange(idx.shape[1], device=idx.device)[None, :] < counts[:, None]
    return r, idx[mask].to(torch.int32)


def _refine_edge_values(xj: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                        block: int = REFINE_BLOCK) -> torch.Tensor:
    """The edges' distances in DIFFERENCE form, sqrt(sum((x_r - x_c)^2)),
    on xj's device, ``block`` edges at a time (two [block, d] gathers):
    O(E d), and without the expansion form's cancellation."""
    out = torch.empty(len(r), dtype=torch.float32, device=xj.device)
    for e0 in range(0, len(r), block):
        e1 = min(e0 + block, len(r))
        diff = xj[r[e0:e1]].sub_(xj[c[e0:e1]])
        out[e0:e1] = diff.mul_(diff).sum(1).sqrt_()
    return out


def rips_at_scale_sparse(x, maxdim: int = 2, target_degree: int = 40,
                         degree_headroom: float = 4.0, block_rows: int = 8192,
                         fused_max: int = 16384, device=None, mesh=None, *,
                         _with_csr: bool = False) -> dict:
    """VR persistence of a large cloud from its thresholded neighbour
    graph: the threshold (the median over 512 rows of the target_degree-th
    neighbour distance) and the edges within it on the card, the edge
    values refined there in difference form, H0..maxdim in the native
    CSR engine on the host.  Exact by construction: a row with
    target_degree * degree_headroom or more neighbours within the
    threshold raises instead of truncating.

    Returns {"dgms", "thresh", "n_edges", "timings": {stage: s}} (host
    clock; each device stage ends in a synchronise).  Edges within ~1e-4
    relative of the threshold may fall on either side of it: membership
    is decided in the expansion form, values are difference form.

    With ``mesh`` the blocked branch (n > ``fused_max``) is collective:
    ``sharded_edge_extract`` over the mesh's dp axis (its first axis
    without one), ``min(block_rows, 2048)`` rows a chunk, then the CSR
    tail on the mesh's first rank, whose result every rank returns.  The
    fused branch ignores the mesh, as tdax's does."""
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    xj = as_device_f32(x, device)
    get_device(xj.device)  # the precision switches (TF32 off), for a tensor passed in too
    _sync(xj.device)
    timings["upload_s"] = time.perf_counter() - t0
    n = xj.shape[0]

    if n <= fused_max:
        t0 = time.perf_counter()
        row_budget = min(int(target_degree * degree_headroom), n - 1)
        cols, counts, prefix_ok, truncated, t = _fused_extract_small(
            xj, n, target_degree, row_budget)
        if int(truncated):
            raise ValueError(f"{int(truncated)} rows have >= {row_budget} neighbors "
                             f"within the threshold; raise degree_headroom")
        thresh = float(t)
        r, c = _edges_from_prefix(cols, counts, bool(prefix_ok))
        _sync(xj.device)
        timings["extract_s"] = time.perf_counter() - t0
        return _sparse_csr_tail(xj, n, r, c, thresh, maxdim, timings, _with_csr)

    t0 = time.perf_counter()
    thresh = _select_threshold(xj, n, target_degree)
    timings["thresh_s"] = time.perf_counter() - t0
    block_rows = min(block_rows, n)
    row_budget = int(target_degree * degree_headroom)

    if mesh is not None:
        # rows sharded over the mesh, each rank its shard against the
        # whole cloud; the same contract (column-sorted kept prefixes and
        # counts), so the CSR tail is shared.  tdax honours the mesh on
        # this branch only: the fused one above returns before it.
        from tdax_torch.parallel.sharded_ops import sharded_edge_extract
        t0 = time.perf_counter()
        axis = "dp" if "dp" in mesh.shape else next(iter(mesh.shape))
        cols, counts, n_trunc = sharded_edge_extract(xj, thresh, row_budget, mesh, axis=axis,
                                                     chunk=min(block_rows, 2048))
        if n_trunc:
            raise ValueError(f"{n_trunc} rows have >= {row_budget} neighbors within the "
                             f"threshold; raise degree_headroom")
        r, c = _edges_from_prefix(torch.from_numpy(cols).to(xj.device),
                                  torch.from_numpy(counts).to(xj.device, torch.int64), True)
        _sync(xj.device)
        timings["extract_s"] = time.perf_counter() - t0
        if not pm.is_first_rank(mesh):
            return pm.broadcast_object(None, mesh)
        return pm.broadcast_object(
            _sparse_csr_tail(xj, n, r, c, thresh, maxdim, timings, _with_csr), mesh)

    # every block is launched before any result is read back
    t0 = time.perf_counter()
    sq = (xj * xj).sum(1)
    blocks = [_extract_block(xj, sq, row0, min(row0 + block_rows, n), thresh, row_budget)
              for row0 in range(0, n, block_rows)]
    timings["dispatch_s"] = time.perf_counter() - t0
    truncated = torch.stack([b[3] for b in blocks]).cpu()
    if truncated.any():
        i = int(torch.nonzero(truncated)[0])
        raise ValueError(f"{int(truncated[i])} rows in block {i * block_rows} have >= "
                         f"{row_budget} neighbors within the threshold; raise degree_headroom")
    prefix_ok = bool(torch.stack([b[2] for b in blocks]).all())
    r, c = _edges_from_prefix(torch.cat([b[0] for b in blocks]),
                              torch.cat([b[1] for b in blocks]), prefix_ok)
    del blocks
    _sync(xj.device)
    timings["extract_s"] = time.perf_counter() - t0
    return _sparse_csr_tail(xj, n, r, c, thresh, maxdim, timings, _with_csr)


def _sparse_csr_tail(xj: torch.Tensor, n: int, r: torch.Tensor, c: torch.Tensor,
                     thresh: float, maxdim: int, timings: dict, with_csr: bool) -> dict:
    """The CSR, the refined values and the engine.

    The CSR is the union of the kept (r, c) and their reverses, rows and
    columns ascending (the engine's contract is a symmetric graph; the
    blocked product need not be bitwise symmetric across blocks).  Each
    unordered pair is refined once and its value written to both slots,
    so (r, c) and (c, r) are bitwise equal."""
    t0 = time.perf_counter()
    key = torch.unique(torch.cat([r * n + c, c.to(torch.int64) * n + r]))  # sorted
    a, b = key // n, key % n
    upper = a < b
    slot = torch.searchsorted(key[upper], torch.minimum(a, b) * n + torch.maximum(a, b))
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(a, minlength=n), 0)
    indptr = indptr.cpu().numpy()
    indices = b.to(torch.int32).cpu().numpy()
    timings["csr_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = _refine_edge_values(xj, a[upper], b[upper])[slot].cpu().numpy()
    timings["refine_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dgms = rips_sparse(indptr, indices, data, maxdim=maxdim)
    timings["engine_s"] = time.perf_counter() - t0
    # the engine is host work after the last device work of the call
    timings["device_idle_s"] = timings["engine_s"]
    out = {"dgms": dgms, "thresh": thresh, "n_edges": len(indices) // 2, "timings": timings}
    if with_csr:
        out["_csr"] = {"indptr": indptr, "indices": indices, "data": data,
                       "added_by_union": len(key) - len(r)}
    return out
