"""H0 persistence on the card: Boruvka MST over a dense distance matrix
(port of ``tdax/ops/rips/mst.py``).

For Vietoris-Rips the H0 diagram is exactly {(0, w) : w an MST edge
weight} plus one essential (0, inf) bar per connected component, so H0
at the 10k-point scale never leaves the device: ceil(log2 n) rounds of
masked row minima and per-component minima (``scatter_reduce`` "amin",
tdax's ``segment_min``) over the matrix already in device memory; no
edge sort, no host union-find.

With distinct weights a component's cheapest outgoing edge to a
partner is also the partner's cheapest edge to it, so 2-cycle
contraction drops exactly the duplicate; with ties either choice gives
an MST with the same weight multiset, and the diagram depends only on
the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tdax_torch.runtime import as_device_f32


def _boruvka(dist: torch.Tensor, thresh: float) -> torch.Tensor:
    """[n-1] MST weights ascending (f32, on dist's device); +inf marks a
    missing edge (components disconnected under the threshold)."""
    n = dist.shape[0]
    dev = dist.device
    rounds = max(math.ceil(math.log2(max(n, 2))), 1)
    inf = float("inf")
    vidx = torch.arange(n, device=dev)

    d = dist.clone()
    d.fill_diagonal_(inf)
    d.masked_fill_(~(d <= thresh), inf)  # thresh compared in f32, as in tdax

    comp = vidx.clone()
    weights = torch.full((n,), inf, device=dev)  # n-1 edges + 1 trash slot
    count = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(rounds):
        # each vertex's cheapest edge leaving its component
        dm = d.masked_fill(comp[:, None] == comp[None, :], inf)
        row_arg = dm.argmin(dim=1)
        row_min = dm.gather(1, row_arg[:, None])[:, 0]
        del dm

        # per-component minimum and its lowest proposing vertex
        comp_min = torch.full((n,), inf, device=dev).scatter_reduce(0, comp, row_min, "amin")
        is_min = torch.isfinite(row_min) & (row_min == comp_min[comp])
        cand = torch.where(is_min, vidx, n)
        u_star = torch.full((n,), n, device=dev).scatter_reduce(0, comp, cand, "amin")
        has_edge = u_star < n
        u = u_star.clamp_max(n - 1)
        partner = torch.where(has_edge, comp[row_arg[u]], vidx)

        # contract the proposal forest; break 2-cycles at the smaller label
        parent = torch.where(has_edge, partner, vidx)
        two_cycle = (parent[parent] == vidx) & (vidx < parent)
        parent = torch.where(two_cycle, vidx, parent)

        # accepted edges: one per non-root component with a proposal
        accept = has_edge & (parent != vidx)
        w = torch.where(accept, comp_min, inf)
        pos = torch.where(accept, count + accept.long().cumsum(0) - 1, n - 1)
        weights = weights.scatter_reduce(0, pos, w, "amin")
        count = count + accept.sum()

        # pointer-jump to the roots, relabel the vertices' components
        root = parent
        for _ in range(rounds + 1):
            root = root[root]
        comp = root[comp]
    return torch.sort(weights[:-1]).values


def boruvka_batched(dist: torch.Tensor) -> torch.Tensor:
    """[L, n, n] -> [L, n-1] MST weights of each matrix, ascending, no
    threshold (tdax ``vmap``s ``_boruvka``; here one call per matrix, on
    dist's device)."""
    return torch.stack([_boruvka(d, float("inf")) for d in dist])


def boruvka_mst_weights(dist, thresh: float = np.inf, device=None) -> np.ndarray:
    """[n-1] MST edge weights ascending; +inf entries mark missing edges.

    ``dist`` is placed by ``runtime.as_device_f32``: a tensor is used
    where it lies, an array goes to the card unless ``device`` says
    otherwise."""
    dist = as_device_f32(dist, device)
    if dist.shape[0] <= 1:
        return np.zeros((0,), np.float32)
    return _boruvka(dist, float(thresh)).cpu().numpy()


def h0_diagram_device(dist, thresh: float = np.inf, device=None) -> np.ndarray:
    """ripser-compatible dgm0 (tdax's ``h0_diagram_tpu``): finite (0, w)
    bars for the positive MST weights, one (0, inf) bar per connected
    component."""
    w = boruvka_mst_weights(dist, thresh, device)
    finite = w[np.isfinite(w)]
    finite = finite[finite > 0]
    n_components = 1 + int(np.sum(~np.isfinite(w)))
    bars = np.zeros((len(finite) + n_components, 2), np.float64)
    bars[:len(finite), 1] = finite
    bars[len(finite):, 1] = np.inf
    return bars
